"""The port's host events on torch.profiler's trace, and the collector's
pauses.

Three pieces, each cheap while no profiler records:

  The bridge — `Tracer.span` (utils/observe.py) calls `enter(name)`
    when a span opens and `leave(handle)` when it ends, on the same
    thread. While torch.profiler records, that is a host
    range of the span's name in the profiler's trace; otherwise it is
    one check of a process-wide flag and nothing is allocated. The
    span's start stays `time.time()`, the Unix wall clock on which the
    profiler stamps its host events, so a span and its range line up.
    torch is never imported here: without it loaded, nothing records.

  `TimedSpan` — the span the tracer hands out: it also stamps the
    monotonic clock when it opens and closes, and its duration is read
    from those stamps (`duration_ns`). `Server.query` reads its
    `extensions.server_latency` from its stage spans' durations.

  The collector hook — `install_gc_hook()` puts `_on_gc` on
    `gc.callbacks`. Per generation it adds each collection's pause and
    count to plain module totals, and while the profiler records it
    opens a `gc.gen0`/`gc.gen1`/`gc.gen2` host range around the pause.
    The callback takes no lock: a collection can start on a thread that
    holds `METRICS`' or the tracer's lock (both allocate under it), so a
    callback that took either would deadlock. `publish_gc()` moves the
    totals into the `gc_gen*` counters outside the collector; the server
    calls it at the end of every read. They mirror the Go runtime's
    `go_gc_duration_seconds` that Dgraph exports.
"""

from __future__ import annotations

import gc
import sys
import threading
import time

from dgraph_tpu_torch.utils.observe import METRICS, Span, declare_metric

GENERATIONS = (0, 1, 2)
_GC_NAMES = tuple(f"gc.gen{g}" for g in GENERATIONS)

declare_metric(
    "counter", "gc_gen*_pause_seconds_total",
    "Seconds the interpreter's garbage collector paused, per generation "
    "(gc_gen0/1/2_...; utils/hosttrace.py): the Go runtime's "
    "go_gc_duration_seconds in Dgraph.",
)
declare_metric(
    "counter", "gc_gen*_collections_total",
    "Garbage collections, per generation (gc_gen0/1/2_...; "
    "utils/hosttrace.py).",
)


# -- the bridge ---------------------------------------------------------------


def active() -> bool:
    """Whether torch.profiler records in this process (the flag
    torch.profiler sets for every thread while it records)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and bool(getattr(prof, "_is_profiler_enabled", False))


def enter(name: str):
    """A profiler host range named `name`, opened on this thread, or
    None where no profiler records.

    The range is recorded in the function scope, as an operator is. A
    `record_function` range is in the user scope, and the profiler also
    draws such a range on the device's timeline around the kernels
    launched inside it, where it would read as device work."""
    if not active():
        return None
    rec = sys.modules["torch"]._C._profiler._RecordFunctionFast(name)
    rec.__enter__()
    return rec


def leave(rec) -> None:
    """Close a range `enter` opened (on the thread that opened it)."""
    if rec is not None:
        rec.__exit__(None, None, None)


class TimedSpan(Span):
    """A span with monotonic stamps: `t0` when it opens, `t1` when
    `close` stamps its end."""

    __slots__ = ("t0", "t1")

    def __init__(self, name, trace_id, span_id, parent_id, sampled=True):
        super().__init__(name, trace_id, span_id, parent_id, sampled)
        self.t0 = time.monotonic_ns()
        self.t1 = 0

    def close(self) -> None:
        self.t1 = time.monotonic_ns()
        self.end = time.time()

    @property
    def duration_ns(self) -> int:
        """Open to close on the monotonic clock; to now while open."""
        return (self.t1 or time.monotonic_ns()) - self.t0

    @property
    def seconds(self) -> float:
        return self.duration_ns / 1e9


# -- the collector's pauses ---------------------------------------------------

# per generation: paused seconds and collections since the process
# started; written by the collector's callback alone (one collection
# runs at a time), read by `publish_gc`
_PAUSE_S = [0.0, 0.0, 0.0]
_COLLECTIONS = [0, 0, 0]
# the running collection: its start and its host range
_RUNNING = [0.0, None]
# what `publish_gc` has moved into METRICS so far
_PUBLISHED_S = [0.0, 0.0, 0.0]
_PUBLISHED_N = [0, 0, 0]
_PUBLISH_LOCK = threading.Lock()


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _RUNNING[1] = enter(_GC_NAMES[info["generation"]])
        _RUNNING[0] = time.perf_counter()
        return
    g = info["generation"]
    _PAUSE_S[g] += time.perf_counter() - _RUNNING[0]
    _COLLECTIONS[g] += 1
    rec, _RUNNING[1] = _RUNNING[1], None
    leave(rec)


def install_gc_hook() -> None:
    """Put the collector hook on `gc.callbacks`, once a process."""
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def gc_hook_installed() -> bool:
    return _on_gc in gc.callbacks


def publish_gc() -> None:
    """Add the pauses and collections counted since the last call to the
    `gc_gen*` counters."""
    with _PUBLISH_LOCK:
        for g in GENERATIONS:
            n = _COLLECTIONS[g]
            if n == _PUBLISHED_N[g]:
                continue
            s = _PAUSE_S[g]
            METRICS.inc(f"gc_gen{g}_pause_seconds_total", s - _PUBLISHED_S[g])
            METRICS.inc(f"gc_gen{g}_collections_total", n - _PUBLISHED_N[g])
            _PUBLISHED_S[g], _PUBLISHED_N[g] = s, n
