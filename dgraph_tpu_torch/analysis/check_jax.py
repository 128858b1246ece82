"""JAX hygiene checker for the device data plane (ops/, query/dispatch.py).

Inside a jit-traced function, host numpy is at best a silent constant-
fold (the np result is baked into the trace, wrong when inputs change)
and at worst a TracerConversionError or an implicit device->host sync.
The device kernels are the paper's hot path; a stray `np.` there
defeats the whole dispatch design.

Defect classes (scoped to functions that are actually jitted — plain
helpers may use numpy freely):

  np-in-jit — a call through the numpy module alias inside a function
    decorated with @jax.jit / @functools.partial(jax.jit, ...) or
    wrapped as `f = jax.jit(g)`.
  host-sync-in-jit — `.item()` / `.tolist()` / `np.asarray(...)` /
    `float(tracer)`-style `.block_until_ready()` calls inside a jitted
    function: each forces a device sync (or fails to trace).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from dgraph_tpu_torch.analysis.core import (
    Source,
    Violation,
    dotted,
    module_aliases,
)

NAME = "jax-hygiene"

SCOPE_PREFIXES = ("ops/",)
SCOPE_FILES = ("query/dispatch.py",)

_SYNC_METHODS = {"item", "tolist", "block_until_ready"}


def _in_scope(rel: str) -> bool:
    return rel.startswith(SCOPE_PREFIXES) or rel in SCOPE_FILES


def _numpy_aliases(tree: ast.Module) -> Set[str]:
    names = module_aliases(tree, "numpy")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    names.add(a.asname or "numpy")
    return names


def _jit_decorated(fn: ast.AST, jax_aliases: Set[str]) -> bool:
    def is_jit(expr: ast.AST) -> bool:
        name = dotted(expr)
        if name in ("jit",):
            return True
        parts = name.split(".")
        return len(parts) == 2 and parts[0] in jax_aliases and \
            parts[1] == "jit"

    for dec in getattr(fn, "decorator_list", []):
        if is_jit(dec):
            return True
        if isinstance(dec, ast.Call):
            if is_jit(dec.func):
                return True
            # functools.partial(jax.jit, ...)
            if dotted(dec.func).rsplit(".", 1)[-1] == "partial" and \
                    dec.args and is_jit(dec.args[0]):
                return True
    return False


def _wrapped_names(tree: ast.Module, jax_aliases: Set[str]) -> Set[str]:
    """Function names wrapped as `f = jax.jit(g)` / `g = jit(g)`."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = dotted(node.value.func)
            parts = name.split(".")
            if name == "jit" or (
                len(parts) == 2 and parts[0] in jax_aliases
                and parts[1] == "jit"
            ):
                for a in node.value.args:
                    if isinstance(a, ast.Name):
                        out.add(a.id)
    return out


def check(sources: List[Source], root: str) -> List[Violation]:
    out: List[Violation] = []
    for src in sources:
        if src.tree is None or not _in_scope(src.rel):
            continue
        jax_aliases = module_aliases(src.tree, "jax") | {"jax"}
        np_aliases = _numpy_aliases(src.tree)
        wrapped = _wrapped_names(src.tree, jax_aliases)

        def scan_jitted(fn: ast.FunctionDef):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                parts = name.split(".")
                if parts and parts[0] in np_aliases:
                    code = (
                        "host-sync-in-jit"
                        if parts[-1] in ("asarray", "array")
                        else "np-in-jit"
                    )
                    out.append(Violation(
                        NAME, code, src.rel, node.lineno,
                        f"{name}() inside jitted {fn.name}() — host "
                        f"numpy constant-folds into the trace (use jnp)",
                    ))
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS
                ):
                    out.append(Violation(
                        NAME, "host-sync-in-jit", src.rel, node.lineno,
                        f".{node.func.attr}() inside jitted {fn.name}() "
                        f"— forces a device->host sync at trace/run "
                        f"time",
                    ))

        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _jit_decorated(node, jax_aliases) or \
                        node.name in wrapped:
                    scan_jitted(node)
    return out
