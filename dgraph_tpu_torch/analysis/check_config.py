"""config-registry checker: every environment read goes through x/config.

Defect classes:

  raw-dgraph-env — a `DGRAPH_TPU_*` variable read or written via raw
    `os.environ` / `os.getenv` outside x/config.py. These previously
    duplicated defaults per call site (and let them drift); the typed
    registry is the single source of truth, so any raw access is a
    hard violation — migrate to `config.get` / `config.set_env`.

  raw-env-read — any other `os.environ` / `os.getenv` access outside
    x/config.py. Foreign-runtime knobs (JAX_PLATFORMS, XLA_FLAGS,
    subprocess environment inheritance) are legitimately raw, but each
    site must carry an allowlist entry stating why, so new env
    couplings can't slip in silently.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from dgraph_tpu_torch.analysis.core import (
    Source,
    Violation,
    dotted,
    imported_names,
    module_aliases,
)

NAME = "config-registry"
EXEMPT = ("x/config.py",)

_ENV_METHODS = {"get", "setdefault", "pop", "__getitem__", "update"}


def _literal_key(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _env_access_key(src: Source, environ_node: ast.AST) -> Optional[str]:
    """The env-var name touched through this `os.environ` node, when it
    is a literal: environ["X"], environ.get("X", ...), os.getenv("X")."""
    parents = src.parent_map()
    p = parents.get(environ_node)
    if isinstance(p, ast.Subscript):
        return _literal_key(p.slice)
    if isinstance(p, ast.Attribute) and p.attr in _ENV_METHODS:
        call = parents.get(p)
        if isinstance(call, ast.Call) and call.args:
            return _literal_key(call.args[0])
    return None


def check(sources: List[Source], root: str) -> List[Violation]:
    out: List[Violation] = []
    for src in sources:
        if src.tree is None or src.rel in EXEMPT:
            continue
        os_names = module_aliases(src.tree, "os")
        from_os = imported_names(src.tree, "os")  # from os import environ
        for node in ast.walk(src.tree):
            key = None
            line = getattr(node, "lineno", 1)
            what = None
            if isinstance(node, ast.Attribute) and node.attr in (
                "environ", "getenv", "putenv", "unsetenv"
            ):
                base = node.value
                if isinstance(base, ast.Name) and base.id in os_names:
                    what = f"os.{node.attr}"
                    if node.attr == "environ":
                        key = _env_access_key(src, node)
                    elif node.attr == "getenv":
                        call = src.parent_map().get(node)
                        if isinstance(call, ast.Call) and call.args:
                            key = _literal_key(call.args[0])
            elif isinstance(node, ast.Name) and node.id in from_os and \
                    from_os[node.id] in ("environ", "getenv"):
                what = f"os.{from_os[node.id]}"
                if from_os[node.id] == "environ":
                    key = _env_access_key(src, node)
                else:  # bare getenv("X"): the Name is the call func
                    call = src.parent_map().get(node)
                    if isinstance(call, ast.Call) and call.func is node \
                            and call.args:
                        key = _literal_key(call.args[0])
            if what is None:
                continue
            # one finding per environ/getenv mention; classify by key
            if key is not None and key.startswith("DGRAPH_TPU_"):
                out.append(Violation(
                    checker=NAME,
                    code="raw-dgraph-env",
                    path=src.rel,
                    line=line,
                    message=(
                        f"raw {what} access of {key} — DGRAPH_TPU_* knobs "
                        f"must go through dgraph_tpu_torch.x.config "
                        f"(get/set_env)"
                    ),
                ))
            else:
                shown = key or "<dynamic>"
                out.append(Violation(
                    checker=NAME,
                    code="raw-env-read",
                    path=src.rel,
                    line=line,
                    message=(
                        f"raw {what} access ({shown}) outside x/config.py "
                        f"— register a knob or allowlist with a reason"
                    ),
                ))
    return out
