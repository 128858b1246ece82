"""High-QPS serving front: cross-query micro-batching, plan cache,
admission control (ROADMAP open item 3).

Millions of users means thousands of concurrent *small* queries, not one
big one. The per-query machinery below this package (level-batched task
fan-out, zero-decode set-op kernels) made one dispatch cheap and
amortizable; this package amortizes it *across* queries:

  MicroBatcher   — holds concurrent same-shape (predicate, level) tasks
                   from different in-flight queries for a bounded window
                   and coalesces them into ONE vectorized read over a
                   shared ragged (flat_uids, offsets) buffer, demuxing
                   per-query row slices on return (serving/microbatch.py).

  PlanCache      — parsed-query cache keyed on the normalized query
                   shape (dql token stream with literal values stripped),
                   LRU-bounded, commit-epoch invalidated, with per-shape
                   cost statistics that feed admission control
                   (serving/plancache.py).

  AdmissionController — token-based admission gate at the query entry
                   points: tracks in-flight cost, sheds over-limit
                   traffic fast with a retryable too_many_requests
                   error, and degrades (bounded budget + partial
                   response) instead of queueing when the slow-query
                   signal says the server is saturated
                   (serving/admission.py).

  ResultCache    — snapshot-keyed whole-response reuse: wire bytes
                   served from a bounded LRU keyed on (normalized
                   shape, literal bindings, variables, namespace,
                   snapshot watermark, commit epoch) — provably
                   byte-identical until a commit advances the
                   watermark (serving/resultcache.py, PR 15).

  ServingFront   — the per-engine bundle of the four, constructed by
                   api/server.Server and worker/harness.ProcCluster
                   (serving/front.py). Also mints the per-query
                   ReadContext (read_context()) for the resilient read
                   plane: one shared retry/hedge RetryBudget per query
                   plus the leaderless-serving notes that become the
                   `degraded: leaderless` extension (worker/remote.py).
"""

from dgraph_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController,
    TooManyRequestsError,
)
from dgraph_tpu_torch.serving.front import ServingFront  # noqa: F401
from dgraph_tpu_torch.serving.microbatch import MicroBatcher  # noqa: F401
from dgraph_tpu_torch.serving.plancache import PlanCache, normalize  # noqa: F401
from dgraph_tpu_torch.serving.resultcache import ResultCache  # noqa: F401
