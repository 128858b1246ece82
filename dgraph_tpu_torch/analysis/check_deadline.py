"""deadline/retry hygiene checker for the cluster stack.

PR 3 unified failure handling behind `conn/retry.RetryPolicy` (jittered
exponential backoff bounded by the ambient `Deadline`). This checker
keeps that from regressing inside the cluster directories (conn/,
worker/, zero/, raft/):

  naked-sleep-in-loop — `time.sleep` inside a while/for loop. A fixed
    sleep in a retry loop is exactly the pattern RetryPolicy replaced:
    no jitter (thundering herds), no deadline coupling (sleeps past
    the caller's budget). Poll loops use
    `RetryPolicy(...).sleep(attempt, deadline)`; genuinely periodic
    pumps (raft tick cadence) carry an allowlist entry saying so.

  raw-settimeout-constant — `settimeout(<numeric literal>)` outside
    conn/retry.py. Per-attempt socket budgets must derive from the
    ambient Deadline (`dl.clamp(...)`) or a configured policy value,
    never a constant invented at the call site — that is how the
    pre-PR-3 stack accumulated independent 5s/8s/15s layers.
"""

from __future__ import annotations

import ast
from typing import List

from dgraph_tpu_torch.analysis.core import Source, Violation, sleep_call_matcher

NAME = "deadline-hygiene"

SCOPES = ("conn/", "worker/", "zero/", "raft/")
EXEMPT = ("conn/retry.py",)


def _in_scope(rel: str) -> bool:
    return rel.startswith(SCOPES) and rel not in EXEMPT


def check(sources: List[Source], root: str) -> List[Violation]:
    out: List[Violation] = []
    for src in sources:
        if src.tree is None or not _in_scope(src.rel):
            continue
        lines = src.text.splitlines()
        is_sleep_call = sleep_call_matcher(src.tree)

        def visit(node: ast.AST, loop_depth: int):
            if isinstance(node, (ast.While, ast.For)):
                loop_depth += 1
            if isinstance(node, ast.Call):
                if is_sleep_call(node) and loop_depth > 0:
                    snippet = ""
                    if 0 < node.lineno <= len(lines):
                        snippet = lines[node.lineno - 1].strip()
                    out.append(Violation(
                        NAME, "naked-sleep-in-loop", src.rel, node.lineno,
                        "time.sleep in a loop — retry/poll loops must "
                        "use conn.retry.RetryPolicy (jitter + deadline) "
                        f"[{snippet}]",
                    ))
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "settimeout"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, (int, float))
                ):
                    out.append(Violation(
                        NAME, "raw-settimeout-constant", src.rel,
                        node.lineno,
                        f"settimeout({node.args[0].value!r}) literal — "
                        f"derive per-attempt budgets from the ambient "
                        f"Deadline (conn/retry.py), not a call-site "
                        f"constant",
                    ))
            for sub in ast.iter_child_nodes(node):
                visit(sub, loop_depth)

        visit(src.tree, 0)
    return out
