"""metrics-registry checker: every metric name is declared in observe.py.

The metric-name registry (utils/observe.METRIC_DEFS) is the single
source of truth for what this package exports at
/debug/prometheus_metrics — one line of doc per name, rendered to
METRICS.md. A counter incremented under a typo'd or undeclared name
silently forks a new series nobody scrapes, dashboards keep graphing
the dead one, and the cluster merge sums the wrong thing. This checker
makes that class of drift machine-caught (mirror of the config-registry
checker for DGRAPH_TPU_* knobs).

Defect classes:

  unregistered-metric — a `METRICS.inc/observe/set_gauge/timer` call
    whose literal name is not declared in METRIC_DEFS (exact match or a
    `*` family like span_*_seconds).

  dynamic-metric-name — the name is an f-string whose constant shape
    does not correspond to a registered `*` family, or a non-literal
    expression the checker cannot resolve. Dynamic families are fine —
    declare the glob (e.g. fault_*_total) and format within it.

Only calls on the module-global `METRICS` registry are checked; local
`Metrics()` instances (tests, ad-hoc registries) are out of scope.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from dgraph_tpu_torch.analysis.core import Source, Violation, dotted
from dgraph_tpu_torch.utils.observe import METRIC_DEFS, registered_metric

NAME = "metrics-registry"

_METHODS = {"inc", "observe", "set_gauge", "timer"}


def _fstring_glob(node: ast.JoinedStr) -> str:
    """Collapse an f-string's formatted fields to `*`, keeping constant
    parts: f"span_{name}_seconds" -> "span_*_seconds"."""
    parts: List[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append("*")
    return "".join(parts)


def _name_arg(call: ast.Call) -> Optional[ast.AST]:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "name":
            return kw.value
    return None


def check(sources: List[Source], root: str) -> List[Violation]:
    out: List[Violation] = []
    for src in sources:
        if src.tree is None:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            target = dotted(node.func)
            if target not in {f"METRICS.{m}" for m in _METHODS}:
                continue
            arg = _name_arg(node)
            line = getattr(node, "lineno", 1)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if not registered_metric(arg.value):
                    out.append(Violation(
                        checker=NAME,
                        code="unregistered-metric",
                        path=src.rel,
                        line=line,
                        message=(
                            f"{target}({arg.value!r}) uses an "
                            f"undeclared metric name — declare it in "
                            f"utils/observe.py METRIC_DEFS (and regen "
                            f"METRICS.md) or fix the typo"
                        ),
                    ))
            elif isinstance(arg, ast.JoinedStr):
                glob = _fstring_glob(arg)
                if glob not in METRIC_DEFS:
                    out.append(Violation(
                        checker=NAME,
                        code="dynamic-metric-name",
                        path=src.rel,
                        line=line,
                        message=(
                            f"{target}(f\"...\") formats the family "
                            f"{glob!r}, which is not a declared `*` "
                            f"family in utils/observe.py METRIC_DEFS"
                        ),
                    ))
            else:
                out.append(Violation(
                    checker=NAME,
                    code="dynamic-metric-name",
                    path=src.rel,
                    line=line,
                    message=(
                        f"{target}(<non-literal>) — metric names must "
                        f"be string literals or f-strings matching a "
                        f"declared `*` family so the registry stays "
                        f"checkable"
                    ),
                ))
    return out
