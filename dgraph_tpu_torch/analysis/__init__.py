"""Project-invariant static-analysis suite (`dgraph-tpu lint`).

Eight AST/source-level checkers, each enforcing an invariant that was
first introduced by convention and is here machine-checked:

  config-registry   every DGRAPH_TPU_* env knob goes through x/config
  lock-discipline   no blocking work / native decodes under known
                    locks; pairwise intra-file acquisition order
  lock-order        the CROSS-module lock-acquisition graph (lexical
                    nesting + resolved call chains) has no cycles —
                    a cycle is a potential deadlock
  shared-state      instance/module state written from thread-entry
                    functions (Thread targets, pool submits) is either
                    lock-guarded or carries a `# race-ok: <reason>`
                    ownership annotation
  deadline-hygiene  retry loops use conn/retry.RetryPolicy; no
                    call-site settimeout constants (conn/worker/zero/raft)
  ctypes-abi        native DECLS match the extern "C" C++ signatures
                    (arity, widths, signedness, restype)
  jax-hygiene       no host numpy / implicit syncs inside jitted fns
                    (ops/, query/dispatch.py)
  metrics-registry  every METRICS.inc/observe/set_gauge/timer name is
                    declared in utils/observe.METRIC_DEFS (METRICS.md)

`run()` scans the installed package by default, applies the allowlist
(`allowlist.py`; every entry carries a reason, stale entries fail the
gate) and returns a Report. Wired into tier-1 via
tests/test_static_analysis.py and into CI via `dgraph-tpu lint
[--json]` (exit 0 clean / 1 violations / 2 internal error).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from dgraph_tpu_torch.analysis import (
    check_config,
    check_ctypes_abi,
    check_deadline,
    check_jax,
    check_lockorder,
    check_locks,
    check_metrics,
    check_shared_state,
)
from dgraph_tpu_torch.analysis.allowlist import ALLOWLIST
from dgraph_tpu_torch.analysis.core import (
    Allow,
    Report,
    Source,
    Violation,
    apply_allowlist,
    load_sources,
)

CHECKERS = {
    check_config.NAME: check_config.check,
    check_locks.NAME: check_locks.check,
    check_lockorder.NAME: check_lockorder.check,
    check_shared_state.NAME: check_shared_state.check,
    check_deadline.NAME: check_deadline.check,
    check_ctypes_abi.NAME: check_ctypes_abi.check,
    check_jax.NAME: check_jax.check,
    check_metrics.NAME: check_metrics.check,
}


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(
    root: Optional[str] = None,
    checkers: Optional[Sequence[str]] = None,
    allows: Optional[Sequence[Allow]] = None,
) -> Report:
    """Run the suite over `root` (default: the dgraph_tpu_torch package)."""
    if root is None:
        root = package_root()
        if allows is None:
            allows = ALLOWLIST
    allows = allows if allows is not None else []
    names = list(checkers) if checkers is not None else list(CHECKERS)
    # a partial run must not report other checkers' entries as stale
    allows = [a for a in allows if a.checker in names or a.checker == "parse"]
    sources = load_sources(root)
    found: List[Violation] = []
    for src in sources:
        if src.tree is None:
            found.append(Violation(
                "parse", "syntax-error", src.rel, 1,
                "file does not parse; all checkers skipped it",
            ))
    for name in names:
        found.extend(CHECKERS[name](sources, root))
    return apply_allowlist(found, allows)


__all__ = [
    "Allow",
    "ALLOWLIST",
    "CHECKERS",
    "Report",
    "Source",
    "Violation",
    "package_root",
    "run",
]
