"""Deliberate exceptions to the analyzer suite — every entry carries a
reason. An entry that stops matching anything makes the gate FAIL
(`unused_allows`), so this list can only shrink or stay honest.

Match semantics (core.Allow): checker + exact repo-relative path +
(`match` == violation code, or `match` is a substring of the message).
One entry may cover several violations of the same class in one file.

shared-state findings do NOT belong here: their sanctioned exception
is the in-source `# race-ok: <ownership reason>` annotation, which
keeps the justification next to the write it excuses. lock-order
cycles have no exception mechanism at all — a real cycle is a
deadlock waiting for a schedule, so fix the ordering.
"""

from __future__ import annotations

from typing import List

from dgraph_tpu_torch.analysis.core import Allow

ALLOWLIST: List[Allow] = [
    # -- config-registry -----------------------------------------------------
    Allow(
        "config-registry", "__init__.py", "raw-env-read",
        "package __init__ seeds the JAX persistent-compile-cache env "
        "BEFORE jax import; these are jax's knobs, not DGRAPH_TPU_* — "
        "routing them through the registry would import-order-invert",
    ),
    Allow(
        "config-registry", "devsetup.py", "raw-env-read",
        "XLA_FLAGS / JAX_PLATFORMS are foreign runtime knobs owned by "
        "jax; force_cpu() must read-modify-write them before the first "
        "backend init",
    ),
    Allow(
        "config-registry", "query/dispatch.py", "raw-env-read",
        "JAX_PLATFORMS is jax's own platform pin; reading it is how the "
        "dispatcher avoids initializing a backend just to learn it is "
        "CPU",
    ),
    Allow(
        "config-registry", "worker/harness.py", "raw-env-read",
        "dict(os.environ) snapshots the WHOLE environment to inherit it "
        "into spawned alpha/zero replicas (incl. fault plans); "
        "env[...]= writes there mutate the child's copy, not this "
        "process",
    ),
    # -- lock-discipline -----------------------------------------------------
    Allow(
        "lock-discipline", "conn/rpc.py", "blocking-under-lock",
        "RpcClient._lock serializes the ONE shared socket per client; "
        "the request/response exchange — including an injected "
        "fault-plan delay simulating a slow link — is exactly the "
        "lock's protected region",
    ),
    # -- deadline-hygiene ----------------------------------------------------
    Allow(
        "deadline-hygiene", "conn/rpc.py", "naked-sleep-in-loop",
        "fault-injection delays (FaultPlan act.delay_s): the sleep IS "
        "the injected network latency under test, not a retry backoff",
    ),
    Allow(
        "deadline-hygiene", "raft/tcp.py", "naked-sleep-in-loop",
        "fault-injection delays (FaultPlan act.delay_s) on the raft "
        "plane — injected latency, not retry backoff",
    ),
    Allow(
        "deadline-hygiene", "zero/zero_process.py", "naked-sleep-in-loop",
        "raft tick pacing: a fixed-cadence periodic pump (20ms logical "
        "ticks), not a retry loop — jitter would skew election timers",
    ),
    Allow(
        "deadline-hygiene", "worker/alpha_process.py", "naked-sleep-in-loop",
        "raft tick pacing, same fixed-cadence pump as zero_process",
    ),
    Allow(
        "deadline-hygiene", "worker/groups.py",
        "self._pump_ms",
        "the cluster pump thread is a fixed-cadence periodic driver "
        "(configured period), not a retry loop",
    ),
]
