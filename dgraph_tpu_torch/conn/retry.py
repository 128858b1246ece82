"""Unified retry policy + deadline propagation for cluster RPCs.

Before this module every call site hand-rolled failure handling: fixed
`time.sleep(0.05)` loops in conn/rpc.py, zero/remote.py and
worker/remote.py, and an independent 5s/8s/15s budget invented at each
layer. This gives the stack one vocabulary:

  RetryPolicy — exponential backoff with FULL JITTER (AWS-style:
    sleep ~ U(0, min(cap, base * mult^attempt))), optionally bounded by
    a max attempt count, always bounded by the caller's Deadline.

  Deadline — a monotonic-clock budget stamped ONCE at the entry point
    (query / commit / admin op) and flowed through every layer beneath:
    RemoteGroup.read/propose, RemoteZero._exec, RpcClient.call all
    clamp their per-attempt timeouts to what remains instead of
    stacking their own defaults.

  deadline_scope — thread-local propagation so the deadline crosses
    layers without threading a parameter through every signature.
    (Worker threads of the parallel executor do not inherit the scope;
    calls made there fall back to per-layer defaults.)

Retries/giveups are counted in utils/observe.METRICS
(`rpc_retries_total`, `rpc_giveups_total` are incremented by the
transports; this module only supplies the arithmetic).
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Optional


class Deadline:
    """An absolute point on the monotonic clock."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + seconds)

    def remaining(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, seconds: float, floor: float = 0.001) -> float:
        """Cap a per-attempt budget to what remains of the deadline."""
        return max(floor, min(seconds, self.remaining()))

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


class RetryPolicy:
    """Exponential backoff + full jitter, deadline-aware."""

    def __init__(
        self,
        base: float = 0.02,
        mult: float = 2.0,
        cap: float = 1.0,
        max_attempts: int = 0,
        rng: Optional[random.Random] = None,
    ):
        self.base = base
        self.mult = mult
        self.cap = cap
        self.max_attempts = max_attempts  # 0 = unbounded (deadline rules)
        self.rng = rng or random.Random()

    def backoff(self, attempt: int) -> float:
        """Jittered sleep for the given 1-based attempt number."""
        ceiling = min(self.cap, self.base * (self.mult ** max(0, attempt - 1)))
        return self.rng.uniform(0.0, ceiling)

    def exhausted(self, attempt: int) -> bool:
        return bool(self.max_attempts) and attempt >= self.max_attempts

    def sleep(self, attempt: int, deadline: Optional[Deadline] = None) -> float:
        """Sleep the jittered backoff, never past the deadline. Returns
        the duration actually slept."""
        d = self.backoff(attempt)
        if deadline is not None:
            d = min(d, max(0.0, deadline.remaining()))
        if d > 0:
            time.sleep(d)
        return d


class RetryBudget:
    """A shared token budget for the retries AND hedges of ONE logical
    operation (a query, a soak step). Every layer that would re-issue an
    RPC — the outer rotation loop in RemoteGroup.read, a hedge fire, a
    retrying_call attempt — draws from the same pool, so a brownout
    (every replica slow, every call timing out) costs at most
    `tokens` extra RPCs instead of multiplying per layer into a retry
    storm. The FIRST attempt of anything is free; only re-issues spend.

    Thread-safe: hedge workers and the calling thread spend
    concurrently."""

    __slots__ = ("capacity", "_left", "_lock")

    def __init__(self, tokens: int):
        self.capacity = int(tokens)
        self._left = int(tokens)
        self._lock = threading.Lock()

    def try_spend(self, n: int = 1) -> bool:
        """Take `n` tokens; False (and takes nothing) when fewer remain."""
        with self._lock:
            if self._left < n:
                return False
            self._left -= n
            return True

    def remaining(self) -> int:
        with self._lock:
            return self._left

    def __repr__(self):
        return f"RetryBudget({self.remaining()}/{self.capacity})"


def retrying_call(
    fn,
    policy: Optional[RetryPolicy] = None,
    deadline: Optional[Deadline] = None,
    retryable: tuple = (),
    budget: Optional[RetryBudget] = None,
):
    """Run `fn()` with backoff-retry on `retryable` exception types —
    the client-side contract of the serving front's admission gate
    (TooManyRequestsError is retryable: shed fast, retry with backoff).
    Also retries any exception whose `retryable` attribute is true.
    Always bounded: the default policy caps attempts, and a policy with
    max_attempts=0 MUST come with a deadline (an unbounded retry loop
    against a persistently-shedding server would never return). With a
    `budget`, each retry additionally spends one token from the shared
    per-operation RetryBudget and the last exception re-raises when the
    pool is dry — the first attempt is always free."""
    policy = policy or RetryPolicy(base=0.005, cap=0.25, max_attempts=8)
    if not policy.max_attempts and deadline is None:
        raise ValueError(
            "retrying_call needs a bounded policy (max_attempts) or a "
            "deadline"
        )
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            is_retryable = isinstance(exc, retryable) or bool(
                getattr(exc, "retryable", False)
            )
            attempt += 1
            if not is_retryable or policy.exhausted(attempt) or (
                deadline is not None and deadline.expired()
            ):
                raise
            if budget is not None and not budget.try_spend():
                raise
            policy.sleep(attempt, deadline)


def poll_policy(interval_s: float) -> RetryPolicy:
    """Jittered fixed-cadence poll: every attempt sleeps
    uniform(0, 2*interval), so the MEAN period equals `interval_s` (the
    old fixed-sleep cadence) while concurrent pollers de-synchronize.
    The sanctioned replacement for `while ...: time.sleep(c)` loops —
    the deadline-hygiene checker flags naked sleeps in the cluster
    directories."""
    return RetryPolicy(
        base=2.0 * interval_s, mult=1.0, cap=2.0 * interval_s
    )


# ---------------------------------------------------------------------------
# thread-local deadline propagation
# ---------------------------------------------------------------------------

_TLS = threading.local()


def current_deadline() -> Optional[Deadline]:
    return getattr(_TLS, "deadline", None)


@contextmanager
def deadline_scope(deadline: Deadline):
    """Install `deadline` as the ambient budget for this thread. Nested
    scopes keep the TIGHTER deadline (an inner layer may shrink the
    budget, never extend it)."""
    prev = getattr(_TLS, "deadline", None)
    if prev is not None and prev.at < deadline.at:
        deadline = prev
    _TLS.deadline = deadline
    try:
        yield deadline
    finally:
        _TLS.deadline = prev


def effective_deadline(default_s: float) -> Deadline:
    """The ambient deadline, or a fresh one of `default_s` — the seam
    every mid-layer uses instead of inventing its own budget."""
    return current_deadline() or Deadline.after(default_s)
