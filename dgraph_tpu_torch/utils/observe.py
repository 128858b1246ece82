"""Observability: metric registry, distributed tracing, query profiles.

Mirrors dgraph/x/metrics.go (ostats counters + latency
distributions exported at /debug/prometheus_metrics) and the opencensus
span plumbing in x/trace (spans around query/mutation/proposal paths,
exported to a collector). Stdlib-only.

Three subsystems:

  Metrics — process-wide counters/gauges/histograms with Prometheus
    text exposition. Every metric NAME is declared in METRIC_DEFS (one
    line of doc per name; `*` entries are families for dynamically
    formatted names like span_*_seconds) — the `metrics-registry`
    analyzer flags METRICS calls with unregistered names, and
    `dgraph-tpu metrics-ref` renders the registry as METRICS.md.
    `parse_exposition` / `merge_expositions` implement the cluster
    aggregation: the facade scrapes every alpha/zero process and merges
    (counters summed, histogram buckets merged on the cumulative grid,
    per-instance labels preserved).

  Tracer — W3C-traceparent-style distributed tracing. Span ids are
    random (128-bit trace / 64-bit span, drawn from os.urandom, so ids
    never collide across forked alpha/zero processes). The CURRENT span
    lives in a contextvars.ContextVar — NOT a thread-local stack — so
    executor pools propagate parents by running submitted work under
    `contextvars.copy_context()`, and RPC servers restore a remote
    parent with the explicit attach/detach API. Sampling is decided at
    the trace root (DGRAPH_TPU_TRACE_SAMPLE) and carried in the
    propagated context; unsampled spans still hit the in-process ring,
    the per-trace buffer, and the latency histograms — only the
    JSONL/OTLP export is skipped, and `force_sample` retro-exports a
    buffered trace (the slow-query path).

  QueryProfile — per-query attribution carried in its own ContextVar:
    per-(predicate, level) task timings, packed-vs-decoded kernel
    counts, decoded bytes, retry/degradation counter deltas, and
    child-server RPC fragments piggybacked on responses. Entry points
    wrap execution in `profile_scope()` and attach the result as
    `extensions.profile`.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

# default latency buckets (seconds) — same decade ladder the reference's
# defaultLatencyMsDistribution covers
_BUCKETS = [
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]


# ---------------------------------------------------------------------------
# metric-name registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MetricDef:
    name: str  # exact name, or a family glob containing `*`
    kind: str  # "counter" | "gauge" | "histogram"
    doc: str


METRIC_DEFS: "OrderedDict[str, MetricDef]" = OrderedDict()


def declare_metric(kind: str, name: str, doc: str) -> None:
    if name in METRIC_DEFS:
        raise ValueError(f"duplicate metric declaration {name!r}")
    METRIC_DEFS[name] = MetricDef(name=name, kind=kind, doc=doc)


def registered_metric(name: str) -> bool:
    """True when `name` is declared exactly or matches a `*` family."""
    if name in METRIC_DEFS:
        return True
    return any(
        "*" in pat and fnmatch.fnmatchcase(name, pat)
        for pat in METRIC_DEFS
    )


def metrics_reference() -> str:
    """The METRICS.md body: one row per declared metric/family."""
    lines = [
        "# METRICS — `dgraph_tpu` metric reference",
        "",
        "Generated from `dgraph_tpu/utils/observe.py` METRIC_DEFS "
        "(`python -m dgraph_tpu.cli metrics-ref`); a tier-1 test asserts "
        "this file matches the registry, and the `metrics-registry` "
        "analyzer flags any `METRICS.inc/observe/set_gauge/timer` call "
        "whose name is not declared here. Names containing `*` are "
        "families covering dynamically formatted metrics. All metrics "
        "are exported with the `dgraph_tpu_` prefix at "
        "`/debug/prometheus_metrics`.",
        "",
        "| Metric | Kind | Description |",
        "|---|---|---|",
    ]
    for name in sorted(METRIC_DEFS):
        d = METRIC_DEFS[name]
        doc = " ".join(d.doc.split())
        lines.append(f"| `{d.name}` | {d.kind} | {doc} |")
    lines.append("")
    return "\n".join(lines)


class Histogram:
    """Cumulative-bucket histogram with a bounded per-bucket exemplar
    ring: the LATEST (value, trace_id, unix_ts) landing in each bucket
    is retained (at most len(buckets)+1 exemplars total), exported in
    OpenMetrics exemplar syntax by `Metrics.render_openmetrics` so a
    dashboard's latency bucket links straight to a trace."""

    def __init__(self, buckets: Optional[List[float]] = None):
        self.buckets = buckets or _BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        # one slot per bucket (incl. +Inf): (value, trace_id, unix_ts)
        self.exemplars: List[Optional[Tuple[float, int, float]]] = (
            [None] * (len(self.buckets) + 1)
        )

    def observe(self, v: float, trace_id: int = 0):
        self.sum += v
        self.total += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                if trace_id:
                    self.exemplars[i] = (v, trace_id, time.time())
                return
        self.counts[-1] += 1
        if trace_id:
            self.exemplars[-1] = (v, trace_id, time.time())


class Metrics:
    """Process-wide registry; render() emits Prometheus text format."""

    def __init__(self, prefix: str = "dgraph_tpu"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    def inc(self, name: str, delta: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def set_gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = value

    def value(self, name: str) -> float:
        """Current value of a counter/gauge (0 when never touched) — used
        by benchmarks asserting on round-trip counts (level_batch_read
        accounting) without parsing the exposition text."""
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, 0.0)

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        """Counters+gauges whose names start with `prefix` — used by the
        chaos suite and bench.py to diff fault/retry/circuit counters
        around a workload without parsing the exposition text."""
        with self._lock:
            out = {
                k: v for k, v in self._counters.items()
                if k.startswith(prefix)
            }
            out.update(
                {
                    k: v for k, v in self._gauges.items()
                    if k.startswith(prefix)
                }
            )
        return out

    def observe(self, name: str, seconds: float, buckets=None):
        """Record one histogram observation. `buckets` overrides the
        default latency ladder on FIRST observation only (count-valued
        histograms like group_commit_batch_size pass a count ladder).

        When exemplars are enabled (DGRAPH_TPU_EXEMPLARS) and a trace
        context is active, the observation is retained as the bucket's
        exemplar — the metrics→trace link render_openmetrics exports.
        Entry-point latency histograms additionally feed the SLO burn
        windows (slo_report)."""
        trace_id = 0
        if _exemplars_enabled():
            cur = _CURRENT.get()
            if cur is not None:
                trace_id = int(getattr(cur, "trace_id", 0) or 0)
        slo = _SLO_TRACKED.get(name)
        if slo is not None:
            slo.note(seconds)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(buckets)
            h.observe(seconds, trace_id)

    def hist_stats(self, name: str) -> Tuple[float, int]:
        """(sum, count) of one histogram (0, 0 when never observed) —
        benchmarks diff this around a run for realized batch widths
        without parsing the exposition text."""
        with self._lock:
            h = self._hists.get(name)
            return (h.sum, h.total) if h is not None else (0.0, 0)

    def hist_snapshot(self) -> Dict[str, Tuple[float, int]]:
        """(sum, count) of EVERY histogram — the metrics-history ring's
        histogram component (per-bucket counts stay out of the ring;
        windowed mean latency needs only sum/count deltas)."""
        with self._lock:
            return {k: (h.sum, h.total) for k, h in self._hists.items()}

    def exemplars(self, name: str) -> List[dict]:
        """The retained exemplars of one histogram: [{le, value,
        trace_id, ts}] — what the slow-query log embeds to close the
        metrics→trace loop without parsing the exposition."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return []
            out = []
            les = [str(b) for b in h.buckets] + ["+Inf"]
            for le, ex in zip(les, h.exemplars):
                if ex is not None:
                    out.append(
                        {
                            "le": le,
                            "value": ex[0],
                            "trace_id": f"{ex[1]:032x}",
                            "ts": ex[2],
                        }
                    )
            return out

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def render(self) -> str:
        out: List[str] = []
        with self._lock:
            for k, v in sorted(self._counters.items()):
                out.append(f"# TYPE {self.prefix}_{k} counter")
                out.append(f"{self.prefix}_{k} {v}")
            for k, v in sorted(self._gauges.items()):
                out.append(f"# TYPE {self.prefix}_{k} gauge")
                out.append(f"{self.prefix}_{k} {v}")
            for k, h in sorted(self._hists.items()):
                base = f"{self.prefix}_{k}"
                out.append(f"# TYPE {base} histogram")
                cum = 0
                for b, c in zip(h.buckets, h.counts):
                    cum += c
                    out.append(f'{base}_bucket{{le="{b}"}} {cum}')
                cum += h.counts[-1]
                out.append(f'{base}_bucket{{le="+Inf"}} {cum}')
                out.append(f"{base}_sum {h.sum}")
                out.append(f"{base}_count {h.total}")
        return "\n".join(out) + "\n"

    def render_openmetrics(self) -> str:
        """OpenMetrics text format with histogram bucket exemplars:

            name_bucket{le="0.1"} 17 # {trace_id="<32hex>"} 0.084 <ts>

        Served at /debug/openmetrics; the classic render() stays the
        Prometheus-text scrape/merge surface (merge_expositions does
        not need exemplars — they are per-process trace anchors, not
        aggregatable counts). Terminated by `# EOF` per the spec."""
        out: List[str] = []
        with self._lock:
            for k, v in sorted(self._counters.items()):
                # OpenMetrics counters sample as <name>_total with the
                # metric FAMILY name in TYPE; most of our counter names
                # already carry the suffix
                fam = k[: -len("_total")] if k.endswith("_total") else k
                out.append(f"# TYPE {self.prefix}_{fam} counter")
                out.append(f"{self.prefix}_{fam}_total {v}")
            for k, v in sorted(self._gauges.items()):
                out.append(f"# TYPE {self.prefix}_{k} gauge")
                out.append(f"{self.prefix}_{k} {v}")
            for k, h in sorted(self._hists.items()):
                base = f"{self.prefix}_{k}"
                out.append(f"# TYPE {base} histogram")
                cum = 0
                rows = list(zip(h.buckets, h.counts, h.exemplars))
                rows.append(("+Inf", h.counts[-1], h.exemplars[-1]))
                for b, c, ex in rows:
                    cum += c
                    line = f'{base}_bucket{{le="{b}"}} {cum}'
                    if ex is not None:
                        val, tid, ts = ex
                        line += (
                            f' # {{trace_id="{tid:032x}"}} '
                            f"{val:.9g} {ts:.3f}"
                        )
                    out.append(line)
                out.append(f"{base}_sum {h.sum}")
                out.append(f"{base}_count {h.total}")
        out.append("# EOF")
        return "\n".join(out) + "\n"


METRICS = Metrics()


def _exemplars_enabled() -> bool:
    from dgraph_tpu_torch.x import config

    return bool(config.get("EXEMPLARS"))


def parse_openmetrics_exemplars(text: str) -> Dict[str, dict]:
    """{series: {"trace_id", "value", "ts"}} for every exemplar-carrying
    line of an OpenMetrics exposition — the round-trip witness that the
    exemplar syntax we emit is the one the OpenMetrics spec defines
    (`<series> <value> # {<labels>} <exemplar-value> [<ts>]`)."""
    out: Dict[str, dict] = {}
    for line in text.splitlines():
        if line.startswith("#") or " # " not in line:
            continue
        series_part, _, ex_part = line.partition(" # ")
        name_part, _, _val = series_part.rpartition(" ")
        if not ex_part.startswith("{"):
            continue
        labels_raw = ex_part[1 : ex_part.index("}")]
        rest = ex_part[ex_part.index("}") + 1 :].split()
        if not rest:
            continue
        try:
            labels = _parse_labels(labels_raw)
            out[name_part] = {
                "trace_id": labels.get("trace_id", ""),
                "value": float(rest[0]),
                "ts": float(rest[1]) if len(rest) > 1 else None,
            }
        except (ValueError, IndexError):
            continue
    return out


# ---------------------------------------------------------------------------
# SLO burn-rate windows (health/SLO rollup)
# ---------------------------------------------------------------------------


class SloWindows:
    """Minute-bucketed (total, over-threshold) rings behind the
    multi-window SLO burn rates in /debug/healthz. A request is "bad"
    when it exceeds DGRAPH_TPU_SLO_QUERY_MS; burn rate over a window is
    bad_fraction / error_budget where the budget is 1 -
    DGRAPH_TPU_SLO_TARGET (burn 1.0 = exactly consuming budget; the
    standard multi-window alert pages on short AND long windows burning
    simultaneously). Fed by Metrics.observe on the entry-point latency
    histograms, so no entry point needs its own SLO call."""

    WINDOWS_S = (60, 300, 1800, 3600)
    _BUCKET_S = 60

    def __init__(self):
        self._lock = threading.Lock()
        # minute-aligned ring: {minute: [total, bad]}
        self._buckets: "OrderedDict[int, List[int]]" = OrderedDict()

    @staticmethod
    def _threshold_s() -> float:
        from dgraph_tpu_torch.x import config

        return float(config.get("SLO_QUERY_MS")) / 1e3

    @staticmethod
    def _target() -> float:
        from dgraph_tpu_torch.x import config

        return min(0.999999, max(0.0, float(config.get("SLO_TARGET"))))

    def note(self, seconds: float) -> None:
        bad = seconds > self._threshold_s()
        minute = int(time.time()) // self._BUCKET_S
        with self._lock:
            b = self._buckets.get(minute)
            if b is None:
                b = self._buckets[minute] = [0, 0]
                # retention: the longest window + one partial bucket
                horizon = minute - max(self.WINDOWS_S) // self._BUCKET_S - 1
                while self._buckets and next(iter(self._buckets)) < horizon:
                    self._buckets.popitem(last=False)
            b[0] += 1
            if bad:
                b[1] += 1

    def report(self) -> dict:
        now_min = int(time.time()) // self._BUCKET_S
        budget = 1.0 - self._target()
        out = {
            "threshold_ms": self._threshold_s() * 1e3,
            "target": self._target(),
            "windows": {},
        }
        with self._lock:
            items = list(self._buckets.items())
        for w in self.WINDOWS_S:
            lo = now_min - w // self._BUCKET_S
            total = sum(t for m, (t, _) in items if m > lo)
            bad = sum(b for m, (_, b) in items if m > lo)
            rate = (bad / total) if total else 0.0
            out["windows"][f"{w}s"] = {
                "total": total,
                "bad": bad,
                "error_rate": round(rate, 6),
                "burn_rate": round(rate / budget, 3) if budget else None,
            }
        return out


# entry-point latency histograms feed the SLO windows on every observe
_SLO_TRACKED: Dict[str, SloWindows] = {
    "query_latency_seconds": SloWindows(),
    "commit_latency_seconds": SloWindows(),
}


def slo_report() -> dict:
    return {name: slo.report() for name, slo in _SLO_TRACKED.items()}


# ---------------------------------------------------------------------------
# Per-tenant SLO slices (flight recorder)
# ---------------------------------------------------------------------------

# bounded per-(kind, namespace) burn windows: the entry points call
# note_tenant on every served query/commit with the resolved namespace,
# so one noisy tenant's burn is visible in healthz before any isolation
# work lands. The cap bounds healthz payload and memory under namespace
# churn — namespaces past it are simply not sliced (the global SLO
# still counts them).
_TENANT_LOCK = threading.Lock()
_TENANT_SLO: Dict[Tuple[str, str], SloWindows] = {}
_TENANT_CAP = 64


def note_tenant(kind: str, ns, seconds: float) -> None:
    """Fold one served operation into its per-namespace SLO window.
    `kind` is "query" or "commit" (mirroring _SLO_TRACKED); `ns` is the
    resolved namespace (any int/str). SloWindows.note locks internally,
    so nothing blocking runs under _TENANT_LOCK."""
    key = (str(kind), str(ns))
    with _TENANT_LOCK:
        slo = _TENANT_SLO.get(key)
        if slo is None:
            if len(_TENANT_SLO) >= _TENANT_CAP:
                return
            slo = _TENANT_SLO[key] = SloWindows()
    slo.note(seconds)


def tenant_slo_report() -> dict:
    """{kind: {ns: SloWindows.report()}} for every sliced tenant."""
    with _TENANT_LOCK:
        items = list(_TENANT_SLO.items())
    out: Dict[str, dict] = {}
    for (kind, ns), slo in sorted(items):
        out.setdefault(kind, {})[ns] = slo.report()
    return out


def tenant_traffic_rollup() -> dict:
    """Per-namespace traffic totals aggregated from the tablet traffic
    table: {ns: {reads, read_uids, mutation_edges, result_bytes}} — the
    healthz tenants section's volume view next to the burn rates."""
    out: Dict[str, dict] = {}
    for r in TABLETS.snapshot():
        t = out.setdefault(
            str(r["ns"]),
            {
                "reads": 0,
                "read_uids": 0,
                "mutation_edges": 0,
                "result_bytes": 0,
            },
        )
        t["reads"] += r["reads"]
        t["read_uids"] += r["read_uids"]
        t["mutation_edges"] += r["mutation_edges"]
        t["result_bytes"] += r["result_bytes"]
    return out


# ---------------------------------------------------------------------------
# Prometheus exposition: parse + multi-instance merge
# ---------------------------------------------------------------------------


def escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping (backslash first)."""
    return (
        v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _unescape_label(v: str) -> str:
    out, i, n = [], 0, len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n:
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(raw: str) -> Dict[str, str]:
    """Parse `a="x",b="y"` with escaped quotes inside values. Raises
    ValueError on malformed input (parse_exposition skips such lines)."""
    labels: Dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        j = raw.index("=", i)  # ValueError when no '=' remains
        key = raw[i:j].strip().strip(",").strip()
        if j + 1 >= n or raw[j + 1] != '"':
            raise ValueError(f"malformed labels {raw!r}")
        k = j + 2
        buf = []
        while k < n:
            c = raw[k]
            if c == "\\" and k + 1 < n:
                buf.append(raw[k : k + 2])
                k += 2
                continue
            if c == '"':
                break
            buf.append(c)
            k += 1
        labels[key] = _unescape_label("".join(buf))
        i = k + 1
        while i < n and raw[i] in ", ":
            i += 1
    return labels


def parse_exposition(text: str) -> dict:
    """Parse the subset of the Prometheus text format this package emits
    into {"counter": {name: v}, "gauge": {name: v},
    "histogram": {name: {"buckets": {le: cum}, "sum": s, "count": c}}}.
    Labeled series are keyed by `name{k="v",...}` with labels sorted.
    Histogram child series (`_bucket`/`_sum`/`_count`) fold into the
    base name declared `# TYPE ... histogram`."""
    types: Dict[str, str] = {}
    out = {"counter": {}, "gauge": {}, "histogram": {}}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name_part, _, val_s = line.rpartition(" ")
        try:
            val = float(val_s)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        name = name_part
        if "{" in name_part:
            name = name_part[: name_part.index("{")]
            try:
                labels = _parse_labels(
                    name_part[
                        name_part.index("{") + 1 : name_part.rindex("}")
                    ]
                )
            except ValueError:
                continue  # malformed labels: skip the line, keep parsing
        # histogram child series?
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    types.get(name[: -len(suffix)]) == "histogram":
                base = name[: -len(suffix)]
                h = out["histogram"].setdefault(
                    base, {"buckets": {}, "sum": 0.0, "count": 0.0}
                )
                if suffix == "_bucket":
                    h["buckets"][labels.get("le", "+Inf")] = val
                elif suffix == "_sum":
                    h["sum"] = val
                else:
                    h["count"] = val
                break
        else:
            kind = types.get(name, "counter")
            kind = kind if kind in ("counter", "gauge") else "counter"
            key = name
            if labels:
                inner = ",".join(
                    f'{k}="{escape_label(v)}"'
                    for k, v in sorted(labels.items())
                )
                key = f"{name}{{{inner}}}"
            out[kind][key] = out[kind].get(key, 0.0) + val
    return out


def _le_sortkey(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def merge_expositions(texts: Dict[str, str]) -> str:
    """Merge per-instance exposition texts into ONE cluster view:
    counters and gauges are summed into an unlabeled series PLUS one
    `{instance="..."}` series per source; histograms are merged exactly
    on the union of their cumulative bucket grids (an instance's
    cumulative count at `le` is its count at the nearest bound <= le,
    so identical ladders merge to exact per-bucket sums)."""
    parsed = {inst: parse_exposition(t) for inst, t in texts.items()}
    counters: Dict[str, Dict[str, float]] = {}
    gauges: Dict[str, Dict[str, float]] = {}
    hists: Dict[str, Dict[str, dict]] = {}
    for inst, p in parsed.items():
        for name, v in p["counter"].items():
            counters.setdefault(name, {})[inst] = v
        for name, v in p["gauge"].items():
            gauges.setdefault(name, {})[inst] = v
        for name, h in p["histogram"].items():
            hists.setdefault(name, {})[inst] = h
    out: List[str] = []
    for kind, table in (("counter", counters), ("gauge", gauges)):
        for name in sorted(table):
            by = table[name]
            out.append(f"# TYPE {name} {kind}")
            out.append(f"{name} {sum(by.values())}")
            for inst in sorted(by):
                sep = "," if name.endswith("}") else ""
                if name.endswith("}"):
                    series = (
                        f'{name[:-1]}{sep}instance='
                        f'"{escape_label(inst)}"}}'
                    )
                else:
                    series = f'{name}{{instance="{escape_label(inst)}"}}'
                out.append(f"{series} {by[inst]}")
    for name in sorted(hists):
        by = hists[name]
        out.append(f"# TYPE {name} histogram")
        les = sorted(
            {le for h in by.values() for le in h["buckets"]},
            key=_le_sortkey,
        )
        for le in les:
            total = 0.0
            for h in by.values():
                # cumulative value at `le`: nearest own bound <= le
                best = 0.0
                for own_le, cum in h["buckets"].items():
                    if _le_sortkey(own_le) <= _le_sortkey(le):
                        best = max(best, cum)
                total += best
            out.append(f'{name}_bucket{{le="{le}"}} {total}')
        out.append(f"{name}_sum {sum(h['sum'] for h in by.values())}")
        out.append(
            f"{name}_count {sum(h['count'] for h in by.values())}"
        )
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class SpanContext(NamedTuple):
    """Propagated trace context (W3C traceparent fields)."""

    trace_id: int
    span_id: int
    sampled: bool


def format_traceparent(ctx: SpanContext) -> str:
    return (
        f"00-{ctx.trace_id:032x}-{ctx.span_id:016x}-"
        f"{'01' if ctx.sampled else '00'}"
    )


def parse_traceparent(header: str) -> Optional[SpanContext]:
    try:
        version, tid, sid, flags = header.strip().split("-")
        if version != "00" or len(tid) != 32 or len(sid) != 16:
            return None
        trace_id, span_id = int(tid, 16), int(sid, 16)
        if not trace_id or not span_id:
            return None
        return SpanContext(trace_id, span_id, bool(int(flags, 16) & 1))
    except (ValueError, AttributeError):
        return None


_FORK_GEN = [0]  # bumped in a fork's child so id streams never share
if hasattr(os, "register_at_fork"):
    os.register_at_fork(
        after_in_child=lambda: _FORK_GEN.__setitem__(0, _FORK_GEN[0] + 1)
    )


class _IdRng(threading.local):
    """Per-thread PRNG for trace/span ids, seeded once from os.urandom.
    Ids stay collision-free across alpha/zero processes (independent
    128-bit urandom seeds per thread; the fork hook reseeds a fork's
    child so parent and child never share a stream — spawn'd replicas
    are fresh interpreters anyway), but the per-ID cost drops from one
    syscall — os.urandom AND os.getpid both measure 100µs+ on some
    sandboxed kernels, dominating span creation on the hot paths — to
    a getrandbits call."""

    def get(self) -> "random.Random":
        if getattr(self, "gen", None) != _FORK_GEN[0]:
            self.rng = random.Random(int.from_bytes(os.urandom(16), "big"))
            self.gen = _FORK_GEN[0]
        return self.rng


_ID_RNG = _IdRng()


def _gen_trace_id() -> int:
    """Random 128-bit trace id; never collides across alpha/zero
    processes (the old sequential per-process counter corrupted merged
    traces)."""
    return _ID_RNG.get().getrandbits(128) or 1


def _gen_span_id() -> int:
    return _ID_RNG.get().getrandbits(64) or 1


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "end",
        "attrs", "sampled", "_exported",
    )

    def __init__(self, name, trace_id, span_id, parent_id, sampled=True):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = time.time()
        self.end: Optional[float] = None
        self.attrs: Dict[str, object] = {}
        self.sampled = sampled
        self._exported = False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_ms": (
                None if self.end is None else (self.end - self.start) * 1e3
            ),
            "sampled": self.sampled,
            "attrs": self.attrs,
        }


def _trace_enabled() -> bool:
    from dgraph_tpu_torch.x import config

    return bool(config.get("TRACE"))


def _sample_root() -> bool:
    from dgraph_tpu_torch.x import config

    ratio = float(config.get("TRACE_SAMPLE"))
    if ratio >= 1.0:
        return True
    if ratio <= 0.0:
        return False
    return int.from_bytes(os.urandom(4), "big") / 2.0**32 < ratio


# the CURRENT span/context: a ContextVar (not a thread-local stack) so
# executor pools inherit parents via contextvars.copy_context().run and
# RPC servers restore remote parents with attach/detach
_CURRENT: "ContextVar[Optional[object]]" = ContextVar(
    "dgraph_tpu_current_span", default=None
)

# cap on the per-trace retention buffer (slow-query force-sampling)
_TRACE_BUF_TRACES = 256
_TRACE_BUF_SPANS = 512


class Tracer:
    """Distributed spans with an in-process ring, a per-trace retention
    buffer, and optional JSONL / OTLP export of SAMPLED spans."""

    def __init__(self, capacity: int = 2048, sink_path: Optional[str] = None):
        self._lock = threading.Lock()
        self.finished: deque = deque(maxlen=capacity)
        self._by_trace: "OrderedDict[int, List[Span]]" = OrderedDict()
        self.sink_path = sink_path
        self._sink = open(sink_path, "a") if sink_path else None

    # -- context API ----------------------------------------------------

    def attach(self, ctx: Optional[SpanContext]):
        """Install a (usually remote) parent context for this execution
        context; returns a token for detach(). New spans parent under it
        and inherit its sampling decision."""
        return _CURRENT.set(ctx)

    def detach(self, token) -> None:
        _CURRENT.reset(token)

    def current_context(self) -> Optional[SpanContext]:
        cur = _CURRENT.get()
        if cur is None:
            return None
        return SpanContext(cur.trace_id, cur.span_id, cur.sampled)

    def current_traceparent(self) -> str:
        ctx = self.current_context()
        return format_traceparent(ctx) if ctx is not None else ""

    def set_sink(self, path: Optional[str]) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
            self.sink_path = path
            self._sink = open(path, "a") if path else None

    # -- spans ----------------------------------------------------------

    @contextmanager
    def span(self, name: str, parent: Optional[SpanContext] = None, **attrs):
        # every span stamps the monotonic clock too, which its duration
        # is read from, and is a host range of torch.profiler's trace
        # while the profiler records (utils/hosttrace.py)
        from dgraph_tpu_torch.utils import hosttrace

        token = None
        if not _trace_enabled():
            sp = hosttrace.TimedSpan(name, 0, 0, None)
        else:
            par = parent if parent is not None else _CURRENT.get()
            if par is None:
                sp = hosttrace.TimedSpan(
                    name, _gen_trace_id(), _gen_span_id(), None,
                    sampled=_sample_root(),
                )
            else:
                sp = hosttrace.TimedSpan(
                    name, par.trace_id, _gen_span_id(), par.span_id,
                    sampled=par.sampled,
                )
            token = _CURRENT.set(sp)
        sp.attrs.update(attrs)
        rec = hosttrace.enter(name)
        try:
            yield sp
        finally:
            sp.close()
            hosttrace.leave(rec)
            if token is not None:
                _CURRENT.reset(token)
                self._finish(sp)
                METRICS.observe(f"span_{name}_seconds", sp.seconds)

    def _finish(self, sp: Span) -> None:
        with self._lock:
            self.finished.append(sp)
            buf = self._by_trace.setdefault(sp.trace_id, [])
            if len(buf) < _TRACE_BUF_SPANS:
                buf.append(sp)
            self._by_trace.move_to_end(sp.trace_id)
            while len(self._by_trace) > _TRACE_BUF_TRACES:
                self._by_trace.popitem(last=False)
            if sp.sampled:
                self._export_locked(sp)

    def _export_locked(self, sp: Span) -> None:
        sp._exported = True
        if self._sink is not None:
            self._sink.write(json.dumps(sp.to_dict()) + "\n")
            self._sink.flush()
        if getattr(self, "_otlp", None) is not None:
            try:  # never block or raise into the traced path
                self._otlp["q"].put_nowait(self._otlp_span_json(sp))
            except Exception:
                METRICS.inc("otlp_spans_dropped")

    def force_sample(self, trace_id: int) -> int:
        """Retro-export every buffered span of `trace_id` that was not
        exported at finish time (the trace was unsampled). The
        slow-query path calls this so slow traces always reach the
        sink. Returns the number of spans exported."""
        n = 0
        with self._lock:
            for sp in self._by_trace.get(trace_id, ()):  # oldest first
                if not sp._exported and sp.end is not None:
                    self._export_locked(sp)
                    n += 1
        return n

    def trace_spans(self, trace_id: int) -> List[dict]:
        """The retained spans of one trace (this process only)."""
        with self._lock:
            return [s.to_dict() for s in self._by_trace.get(trace_id, ())]

    def recent(self, n: int = 100) -> List[dict]:
        with self._lock:
            return [s.to_dict() for s in list(self.finished)[-n:]]

    # -- OTLP/HTTP export (ref x/metrics.go:610 otlp trace wiring) ------

    def enable_otlp(
        self, endpoint: str, service_name: str = "dgraph_tpu",
        batch: int = 64, timeout_s: float = 5.0,
        flush_interval_s: float = 2.0,
    ):
        """Export finished spans to an OTLP/HTTP collector at
        `endpoint`/v1/traces using the OTLP JSON protobuf mapping —
        stdlib-only, batched, and drained by a BACKGROUND thread so a
        slow collector never blocks the traced path (export errors are
        counted, never raised)."""
        import queue

        cfg = self._otlp = {
            "endpoint": endpoint.rstrip("/") + "/v1/traces",
            "service": service_name,
            "batch": batch,
            "timeout": timeout_s,
            "q": queue.Queue(maxsize=8192),
            # the drainer's working batch, shared (under lock) so
            # otlp_flush() can export spans the thread already dequeued
            "pending": [],
            "lock": threading.Lock(),
        }

        def drain():
            q = cfg["q"]
            last_post = time.monotonic()
            while True:
                try:
                    sp = q.get(timeout=flush_interval_s)
                    if sp is None:
                        break
                    with cfg["lock"]:
                        cfg["pending"].append(sp)
                except queue.Empty:
                    pass  # interval tick
                while True:
                    try:
                        sp = q.get_nowait()
                    except queue.Empty:
                        break
                    if sp is None:
                        self.otlp_flush()
                        return
                    with cfg["lock"]:
                        cfg["pending"].append(sp)
                # post only on a full batch or when the flush interval
                # has elapsed — NOT per span (that defeats batching)
                with cfg["lock"]:
                    due = cfg["pending"] and (
                        len(cfg["pending"]) >= batch
                        or time.monotonic() - last_post
                        >= flush_interval_s
                    )
                    spans, cfg["pending"] = (
                        (cfg["pending"], []) if due else ([], cfg["pending"])
                    )
                if spans:
                    self._otlp_post(spans)
                    last_post = time.monotonic()
            self.otlp_flush()

        self._otlp_thread = threading.Thread(target=drain, daemon=True)
        self._otlp_thread.start()

    def otlp_flush(self):
        """Synchronously export everything queued AND whatever the
        drain thread has already dequeued (tests/shutdown)."""
        cfg = getattr(self, "_otlp", None)
        if cfg is None:
            return
        import queue

        with cfg["lock"]:
            pending, cfg["pending"] = cfg["pending"], []
        while True:
            try:
                pending.append(cfg["q"].get_nowait())
            except queue.Empty:
                break
        pending = [p for p in pending if p is not None]
        if pending:
            self._otlp_post(pending)

    def _otlp_span_json(self, sp: "Span") -> dict:
        return {
            "traceId": f"{sp.trace_id:032x}",
            "spanId": f"{sp.span_id:016x}",
            **(
                {"parentSpanId": f"{sp.parent_id:016x}"}
                if sp.parent_id is not None
                else {}
            ),
            "name": sp.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(sp.start * 1e9)),
            "endTimeUnixNano": str(int((sp.end or sp.start) * 1e9)),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in sp.attrs.items()
            ],
        }

    def _otlp_post(self, spans: List[dict]):
        cfg = self._otlp
        body = json.dumps(
            {
                "resourceSpans": [
                    {
                        "resource": {
                            "attributes": [
                                {
                                    "key": "service.name",
                                    "value": {
                                        "stringValue": cfg["service"]
                                    },
                                }
                            ]
                        },
                        "scopeSpans": [
                            {
                                "scope": {"name": "dgraph_tpu.tracer"},
                                "spans": spans,
                            }
                        ],
                    }
                ]
            }
        ).encode()
        import urllib.request

        req = urllib.request.Request(
            cfg["endpoint"], data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=cfg["timeout"]).read()
            METRICS.inc("otlp_spans_exported", len(spans))
        except Exception:
            METRICS.inc("otlp_export_errors")


TRACER = Tracer()


def init_from_env(instance: str = "") -> Tracer:
    """Per-process observability bootstrap: when DGRAPH_TPU_TRACE_SINK
    names a directory, point the global TRACER's JSONL sink at a
    process-unique file inside it (spans-<instance|pid>.jsonl). Called
    by the alpha/zero process mains and the cluster coordinator so a
    multi-process cluster writes one sink file per process."""
    from dgraph_tpu_torch.x import config

    sink_dir = config.get("TRACE_SINK")
    if sink_dir:
        os.makedirs(sink_dir, exist_ok=True)
        label = instance or f"pid{os.getpid()}"
        path = os.path.join(sink_dir, f"spans-{label}.jsonl")
        if TRACER.sink_path != path:
            TRACER.set_sink(path)
    # flight recorder: the metrics-history sampler runs in every
    # bootstrapped process (replaying any on-disk ring first so the
    # retro view survives a restart)
    HISTORY.set_label(instance or f"pid{os.getpid()}")
    if HISTORY.enabled():
        HISTORY.load_disk()
        HISTORY.start()
    return TRACER


# ---------------------------------------------------------------------------
# Per-tablet traffic accounting
# ---------------------------------------------------------------------------


class TabletTraffic:
    """Sharded (namespace, predicate) traffic accumulator — the signal
    the traffic-driven rebalancer consumes (worker/tabletmove.py
    pick_rebalance_move_by_traffic) and /debug/tablets serves.

    Always-on by default (DGRAPH_TPU_TABLET_TRAFFIC): the record path
    must stay cheap enough for every level read and commit, so the
    table shards over SHARDS independent locks keyed by predicate hash
    (a level task touches exactly one shard, and concurrent queries on
    different predicates never contend), and one record is a dict probe
    plus a handful of float adds under that shard lock — no METRICS
    call, no allocation after the first touch of a tablet.

    Per tablet: read tasks + uids, mutation edges, decoded bytes (the
    ragged level buffer the reads materialized), result bytes (what
    survived to the result row), and a latency EWMA over per-task ms.
    Totals are cumulative; scrapers snapshot (drain) on demand, and the
    cluster merge sums rows by (ns, predicate) with a read-weighted
    EWMA average (worker/harness.merge_tablet_rows)."""

    SHARDS = 16
    _EWMA_ALPHA = 0.2

    def __init__(self):
        self._locks = [threading.Lock() for _ in range(self.SHARDS)]
        self._shards: List[Dict[Tuple[int, str], List[float]]] = [
            {} for _ in range(self.SHARDS)
        ]

    # entry layout: [reads, read_uids, mutation_edges, decoded_bytes,
    #                result_bytes, lat_ewma_ms]
    _N_FIELDS = 6

    def _entry(self, shard: dict, ns: int, attr: str) -> List[float]:
        e = shard.get((ns, attr))
        if e is None:
            e = shard[(ns, attr)] = [0.0] * self._N_FIELDS
        return e

    def note_read(
        self, ns: int, attr: str, tasks: int, uids: int,
        decoded_bytes: int, result_bytes: int, ms: float,
    ) -> None:
        i = hash(attr) % self.SHARDS
        with self._locks[i]:
            e = self._entry(self._shards[i], ns, attr)
            first = e[0] == 0
            e[0] += tasks
            e[1] += uids
            e[3] += decoded_bytes
            e[4] += result_bytes
            e[5] = (
                ms if first else e[5] + self._EWMA_ALPHA * (ms - e[5])
            )

    def note_result(self, ns: int, attr: str, nbytes: int) -> None:
        """Bytes of this tablet's data that survived into a query's
        result tree (recorded at node completion, after filters and
        pagination — the serving-value counterpart of decoded_bytes)."""
        if not nbytes:
            return
        i = hash(attr) % self.SHARDS
        with self._locks[i]:
            self._entry(self._shards[i], ns, attr)[4] += nbytes

    def note_write(self, ns: int, attr: str, edges: int) -> None:
        i = hash(attr) % self.SHARDS
        with self._locks[i]:
            self._entry(self._shards[i], ns, attr)[2] += edges

    def snapshot(self) -> List[dict]:
        """One row per tablet, sorted by (ns, predicate) — the
        /debug/tablets body and the rebalancer's input."""
        rows: List[dict] = []
        for lock, shard in zip(self._locks, self._shards):
            with lock:
                items = [(k, list(v)) for k, v in shard.items()]
            for (ns, attr), e in items:
                rows.append(
                    {
                        "ns": int(ns),
                        "predicate": attr,
                        "reads": int(e[0]),
                        "read_uids": int(e[1]),
                        "mutation_edges": int(e[2]),
                        "decoded_bytes": int(e[3]),
                        "result_bytes": int(e[4]),
                        "lat_ewma_ms": round(e[5], 3),
                    }
                )
        rows.sort(key=lambda r: (r["ns"], r["predicate"]))
        return rows

    def publish(self) -> None:
        """Mirror the aggregate into per-alpha gauges (the scrape-time
        drain): tablet count only — per-tablet series ride the JSON
        surface, not the exposition (unbounded label cardinality)."""
        n = sum(len(s) for s in self._shards)
        METRICS.set_gauge("tablet_traffic_tablets", float(n))

    def clear(self) -> None:
        for lock, shard in zip(self._locks, self._shards):
            with lock:
                shard.clear()


TABLETS = TabletTraffic()


def tablet_traffic_enabled() -> bool:
    from dgraph_tpu_torch.x import config

    return bool(config.get("TABLET_TRAFFIC"))


# ---------------------------------------------------------------------------
# Health registry (/debug/healthz)
# ---------------------------------------------------------------------------


_HEALTH_SOURCES: Dict[str, object] = {}
_START_TIME = time.time()


def register_health(name: str, fn) -> None:
    """Register a per-process health source: `fn()` returns a small
    JSON-able dict folded into /debug/healthz under `name`. Engines
    register raft/watermark/pipeline views at construction; a source
    that raises reports {"error": ...} instead of failing the probe."""
    _HEALTH_SOURCES[name] = fn


def healthz(instance: str = "") -> dict:
    """The per-process health rollup: registered sources + admission
    shed/degraded rates + commit pipeline depth + multi-window SLO burn
    rates from the entry-point latency histograms."""
    out: Dict[str, object] = {
        "instance": instance,
        "pid": os.getpid(),
        "uptime_s": round(time.time() - _START_TIME, 1),
        "status": "healthy",
        "admission": {
            "inflight": METRICS.value("admission_inflight_queries"),
            "shed_total": METRICS.value("admission_shed_total"),
            "degraded_total": METRICS.value("admission_degraded_total"),
            "degraded_queries_total": METRICS.value(
                "degraded_queries_total"
            ),
        },
        "commit_pipeline_depth": METRICS.value("commit_pipeline_depth"),
        "slo": slo_report(),
    }
    # per-tenant slices: burn rates + traffic rollups keyed by namespace
    # (empty on single-tenant processes that never resolved an ns)
    tslo = tenant_slo_report()
    ttraffic = tenant_traffic_rollup()
    if tslo or ttraffic:
        out["tenants"] = {"slo": tslo, "traffic": ttraffic}
    sources = {}
    for name, fn in sorted(_HEALTH_SOURCES.items()):
        try:
            sources[name] = fn()
        except Exception as e:  # a broken source must not fail the probe
            sources[name] = {"error": f"{type(e).__name__}: {e}"}
    if sources:
        out["sources"] = sources
    return out


# ---------------------------------------------------------------------------
# Metrics history ring (flight recorder)
# ---------------------------------------------------------------------------


class HistoryLog:
    """On-disk metrics-history ring: one AppendLog record (the shared
    torn-tail-truncating pickle format from worker/tabletmove.py) per
    snapshot, so a crash mid-append costs at most the torn record.
    When the file exceeds DGRAPH_TPU_HISTORY_DISK_MAX_BYTES it is
    rewritten keeping the newest half of its records — the slow-query
    log's hysteresis, so a rotation never happens on consecutive
    appends."""

    K_SNAP = 1

    def __init__(self, path: str):
        # lazy import: tabletmove imports observe at module level, so
        # observe must not import it back at import time
        from dgraph_tpu_torch.worker.tabletmove import AppendLog

        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._log = AppendLog(path, kinds=(self.K_SNAP,), sync=False)

    def append(self, snap: dict) -> int:
        """Append one snapshot; returns rotations performed (0 or 1)."""
        from dgraph_tpu_torch.worker.tabletmove import AppendLog
        from dgraph_tpu_torch.x import config

        self._log._append(self.K_SNAP, snap)
        cap = int(config.get("HISTORY_DISK_MAX_BYTES"))
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return 0
        if cap <= 0 or size <= cap:
            return 0
        snaps = self.scan()
        keep = snaps[len(snaps) // 2:] or snaps[-1:]
        self._log.close()
        tmp = self.path + ".rewrite"
        try:
            os.remove(tmp)
        except OSError:
            pass
        new = AppendLog(tmp, kinds=(self.K_SNAP,), sync=False)
        for s in keep:
            new._append(self.K_SNAP, s)
        new.close()
        os.replace(tmp, self.path)
        self._log = AppendLog(self.path, kinds=(self.K_SNAP,), sync=False)
        return 1

    def scan(self) -> List[dict]:
        """All complete snapshots on disk (a torn tail ends the replay,
        never crashes it — AppendLog._scan's contract)."""
        return [obj for _, obj in self._log._scan()]

    def close(self) -> None:
        self._log.close()


class MetricsHistory:
    """Bounded ring of periodic metrics snapshots — the retrospective
    half of the metrics surface. Each snapshot is {ts, values
    (counters+gauges), hists ({name: [sum, count]})}; `report(window)`
    answers "what changed in the last N seconds" as counter/histogram
    deltas, computable AFTER a spike without a rerun (/debug/history).

    A background sampler appends one snapshot per
    DGRAPH_TPU_HISTORY_INTERVAL_S and mirrors it to the on-disk
    HistoryLog when DGRAPH_TPU_HISTORY_DIR is set (replayed into the
    ring at startup, so the retro view survives a restart). Retention
    is DGRAPH_TPU_HISTORY_RETENTION snapshots. METRICS is never called
    while a history lock is held (lock-order discipline)."""

    def __init__(self, retention: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: "deque" = deque()
        self._retention = retention
        self._label = ""
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._disk_lock = threading.Lock()
        self._disk: Optional[HistoryLog] = None
        self._disk_path: Optional[str] = None

    def retention(self) -> int:
        if self._retention is not None:
            return max(1, int(self._retention))
        from dgraph_tpu_torch.x import config

        return max(1, int(config.get("HISTORY_RETENTION")))

    @staticmethod
    def enabled() -> bool:
        from dgraph_tpu_torch.x import config

        return bool(config.get("HISTORY"))

    def set_label(self, label: str) -> None:
        """Instance label for the on-disk ring's filename (one file per
        process, like the trace sink)."""
        with self._disk_lock:
            self._label = str(label)

    # -- sampling --------------------------------------------------------------

    def record_now(self) -> dict:
        """Take one snapshot now (the sampler's tick; tests call it
        directly). Appends to the in-memory ring and mirrors to disk
        when configured."""
        snap = {
            "ts": time.time(),
            "values": METRICS.snapshot(),
            "hists": {
                k: [s, c]
                for k, (s, c) in METRICS.hist_snapshot().items()
            },
        }
        keep = self.retention()
        with self._lock:
            self._ring.append(snap)
            while len(self._ring) > keep:
                self._ring.popleft()
            n = len(self._ring)
        rotations = self._disk_append(snap)
        METRICS.inc("history_snapshots_total")
        METRICS.set_gauge("history_samples", float(n))
        if rotations:
            METRICS.inc("history_disk_rotations_total", rotations)
        return snap

    def _disk_log_locked(self) -> Optional[HistoryLog]:
        from dgraph_tpu_torch.x import config

        d = config.get("HISTORY_DIR")
        if not d:
            return None
        label = self._label or f"pid{os.getpid()}"
        path = os.path.join(d, f"history-{label}.log")
        if self._disk is None or self._disk_path != path:
            if self._disk is not None:
                self._disk.close()
            self._disk = HistoryLog(path)
            self._disk_path = path
        return self._disk

    def _disk_append(self, snap: dict) -> int:
        with self._disk_lock:
            try:
                log = self._disk_log_locked()
                return log.append(snap) if log is not None else 0
            except OSError:
                return 0

    def load_disk(self) -> int:
        """Replay the on-disk ring into an EMPTY in-memory ring (the
        post-restart retro view). Returns snapshots loaded."""
        with self._disk_lock:
            try:
                log = self._disk_log_locked()
                snaps = log.scan() if log is not None else []
            except OSError:
                snaps = []
        if not snaps:
            return 0
        keep = self.retention()
        loaded = 0
        with self._lock:
            if not self._ring:
                for s in snaps[-keep:]:
                    self._ring.append(s)
                loaded = len(self._ring)
        if loaded:
            METRICS.set_gauge("history_samples", float(loaded))
        return loaded

    def start(self) -> None:
        """Start the background sampler (idempotent). Interval is
        re-read each tick so tests can shrink it live."""
        with self._lock:
            self._stop.clear()
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="metrics-history"
            )
            t = self._thread
        t.start()

    def stop(self) -> None:
        with self._lock:
            self._stop.set()

    def _run(self) -> None:
        from dgraph_tpu_torch.x import config

        stop = self._stop
        while not stop.is_set():
            iv = max(0.05, float(config.get("HISTORY_INTERVAL_S")))
            if stop.wait(iv):
                return
            if not self.enabled():
                continue
            try:
                self.record_now()
            except Exception:
                pass
            try:
                # sustained-burn auto-profile check rides the history
                # tick (one timer thread for the whole flight recorder)
                from dgraph_tpu_torch.utils import profiler

                profiler.AUTO.check()
            except Exception:
                pass

    # -- queries ---------------------------------------------------------------

    def snapshots(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def report(self, window_s: float = 600.0) -> dict:
        """Windowed deltas between the oldest and newest snapshot inside
        `window_s`: {window_s, samples, retained, from_ts, to_ts,
        deltas {counter/gauge: delta}, hist_deltas {name: {sum,
        count}}}. Zero deltas are dropped (payload stays proportional
        to what actually changed)."""
        with self._lock:
            snaps = list(self._ring)
        lo = time.time() - max(0.0, float(window_s))
        win = [s for s in snaps if s["ts"] >= lo]
        out: Dict[str, object] = {
            "window_s": float(window_s),
            "samples": len(win),
            "retained": len(snaps),
        }
        if len(win) < 2:
            return out
        a, b = win[0], win[-1]
        out["from_ts"] = a["ts"]
        out["to_ts"] = b["ts"]
        deltas = {}
        for k, v in b["values"].items():
            d = v - a["values"].get(k, 0.0)
            if d:
                deltas[k] = d
        out["deltas"] = deltas
        hd = {}
        for k, sc in b["hists"].items():
            s0 = a["hists"].get(k, [0.0, 0])
            ds, dc = sc[0] - s0[0], sc[1] - s0[1]
            if ds or dc:
                hd[k] = {"sum": ds, "count": dc}
        out["hist_deltas"] = hd
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


HISTORY = MetricsHistory()


# ---------------------------------------------------------------------------
# Per-query profile
# ---------------------------------------------------------------------------


_PROFILE: "ContextVar[Optional[QueryProfile]]" = ContextVar(
    "dgraph_tpu_query_profile", default=None
)

# process-local counters whose per-query delta the profile reports as
# `events` (retry/degradation/fault attribution)
_PROFILE_EVENT_KEYS = (
    "rpc_retries_total", "rpc_giveups_total", "rpc_refused_total",
    "degraded_group_reads_total", "group_unavailable_failfast_total",
    "hedge_fired_total", "faults_injected_total", "idem_hits_total",
    "circuit_failfast_total", "setop_pairs_total", "setop_packed_total",
    "follower_reads_total", "leaderless_reads_total",
    "read_breaker_open_total", "read_retry_budget_exhausted_total",
    "hedge_skipped_saturated_total",
)


class PlanCapture:
    """EXPLAIN/ANALYZE decision capture for ONE debug-mode query — the
    structured `extensions.plan` tree. Allocated only when the request
    carries `debug: true` (profile_scope(debug=True)), so the normal
    path pays a single None check per hook site. Thread-safe like the
    profile: parallel sibling workers append under one lock.

    What the hooks record:
      nodes       per-(predicate, level) execution nodes from the
                  executor (query/subgraph.py): uids in/out, read
                  strategy, per-thread kernel-count deltas (bitmap/
                  probe/gallop pairs, decoded/streamed uids from the
                  PR 6 counters), wall-ns; assembled into a tree by
                  ExecNode identity.
      setops      packed-vs-decoded decisions at the dispatch sites
                  (query/dispatch._try_packed, functions.
                  _index_src_intersect): operand sizes, StatsHolder
                  selectivity estimate, the PACKED_MIN_RATIO verdict.
                  Capped — a pathological query must not balloon the
                  response.
      microbatch  coalescing outcome per level read (solo vs coalesced,
                  member count) from serving/microbatch.py.
      plan_cache  hit/miss + the normalized shape key
                  (serving/plancache.py via ServingFront.parse).
      admission   the admission decision: estimated cost, degrade flag
                  (serving/admission.py via the entry points).
      cache       cache-tier deltas for this query: memlayer hits/
                  misses, point/batch reads (entry-point stamped).
    """

    MAX_SETOPS = 64

    def __init__(self):
        self._lock = threading.Lock()
        self.nodes: List[dict] = []
        self.setops: List[dict] = []
        self.setops_dropped = 0
        self.microbatch = {"solo": 0, "coalesced": 0, "members_max": 0}
        self.plan_cache: Dict[str, object] = {}
        self.admission: Dict[str, object] = {}
        self.cache: Dict[str, float] = {}
        # cost-based planner decisions for this query: reorder/pushdown
        # counts + the chosen orders (query/planner.Planner.explain())
        self.planner: Dict[str, object] = {}
        # result-cache outcome: enabled/hit tier + the watermark key
        # (the entry points probe without serving on debug queries —
        # EXPLAIN always executes)
        self.result_cache: Dict[str, object] = {}
        self.meta: Dict[str, object] = {}

    def note_node(self, rec: dict) -> None:
        with self._lock:
            self.nodes.append(rec)

    def note_setop(self, rec: dict) -> None:
        with self._lock:
            if len(self.setops) >= self.MAX_SETOPS:
                self.setops_dropped += 1
                return
            self.setops.append(rec)

    def note_microbatch(self, members: int) -> None:
        with self._lock:
            if members > 1:
                self.microbatch["coalesced"] += 1
                self.microbatch["members_max"] = max(
                    self.microbatch["members_max"], members
                )
            else:
                self.microbatch["solo"] += 1

    def tree(self) -> List[dict]:
        """Nest the flat node records into per-block trees by ExecNode
        identity (each record carries its own `id` and `parent` id).
        Orphans (parent never recorded, e.g. the root was a var-only
        block) surface as roots — never silently dropped."""
        with self._lock:
            nodes = [dict(n) for n in self.nodes]
        by_id = {n["id"]: n for n in nodes}
        roots: List[dict] = []
        for n in nodes:
            n["children"] = []
        for n in nodes:
            parent = by_id.get(n.get("parent"))
            if parent is not None:
                parent["children"].append(n)
            else:
                roots.append(n)
        for n in nodes:
            n.pop("id", None)
            n.pop("parent", None)
        return roots

    def to_dict(self) -> dict:
        out = {
            "nodes": self.tree(),
            "setops": list(self.setops),
            "microbatch": dict(self.microbatch),
            "plan_cache": dict(self.plan_cache),
            "admission": dict(self.admission),
            "cache": dict(self.cache),
            "planner": dict(self.planner),
            "result_cache": dict(self.result_cache),
        }
        if self.setops_dropped:
            out["setops_dropped"] = self.setops_dropped
        out.update(self.meta)
        return out


def current_plan() -> Optional[PlanCapture]:
    """The active debug-mode plan capture, or None (the common case —
    every hook site gates on this)."""
    prof = _PROFILE.get()
    return prof.plan if prof is not None else None


class QueryProfile:
    """Attribution for ONE query: per-(predicate, level) task timings,
    packed-vs-decoded kernel counts + decoded bytes, retry/degradation
    counter deltas, and child-server RPC fragments piggybacked on
    responses. Thread-safe: executor workers record into the same
    profile via the propagated context."""

    def __init__(self, debug: bool = False):
        self._lock = threading.Lock()
        # EXPLAIN/ANALYZE capture — allocated only for debug requests
        self.plan: Optional[PlanCapture] = (
            PlanCapture() if debug else None
        )
        self.level_tasks: List[dict] = []
        self.rpc_fragments: List[dict] = []
        self.events: Dict[str, float] = {}
        self.kernel: Dict[str, float] = {}
        self.max_queue_depth = 0  # exec-pool backlog seen by this query
        # result-encoding attribution (query/streamjson.py): encode_ns
        # (wire-bytes production), bytes, stream (which path), parse_ns
        # (dict-API compat parse-back), and the share of total latency
        # stamped by the server at response assembly
        self.encode: Dict[str, float] = {}

    def record_level_task(
        self, attr: str, level: int, parents: int, ms: float,
        batched: bool,
    ) -> None:
        with self._lock:
            self.level_tasks.append(
                {
                    "attr": attr,
                    "level": level,
                    "parents": parents,
                    "ms": round(ms, 3),
                    "batched": batched,
                }
            )

    def record_rpc_fragment(self, frag: dict) -> None:
        with self._lock:
            self.rpc_fragments.append(frag)

    def note_queue_depth(self, depth: int) -> None:
        """Record the exec-pool backlog observed at a fan-out point;
        the profile keeps the query's maximum (its saturation view)."""
        with self._lock:
            if depth > self.max_queue_depth:
                self.max_queue_depth = int(depth)

    def to_dict(self) -> dict:
        with self._lock:
            rpc: Dict[Tuple[str, str], Dict[str, float]] = {}
            for f in self.rpc_fragments:
                k = (str(f.get("i", "?")), str(f.get("m", "?")))
                agg = rpc.setdefault(k, {"calls": 0, "ms": 0.0})
                agg["calls"] += 1
                agg["ms"] += float(f.get("ms", 0.0))
            return {
                "level_tasks": list(self.level_tasks),
                "rpc": [
                    {
                        "instance": i,
                        "method": m,
                        "calls": int(v["calls"]),
                        "ms": round(v["ms"], 3),
                    }
                    for (i, m), v in sorted(rpc.items())
                ],
                "kernel": dict(self.kernel),
                "events": {
                    k: v for k, v in self.events.items() if v
                },
                "encode": dict(self.encode),
                "exec_pool": {
                    "max_queue_depth": self.max_queue_depth
                },
            }


def current_profile() -> Optional[QueryProfile]:
    return _PROFILE.get()


@contextmanager
def profile_scope(debug: bool = False):
    """Collect a QueryProfile for the enclosed query. Counter deltas are
    process-local and can overlap across concurrent queries — they
    attribute classes of work, not exact per-query counts.

    `debug=True` additionally allocates the EXPLAIN/ANALYZE PlanCapture
    (prof.plan): the decision-capture hooks at the dispatch sites go
    live for this query only, and the entry point attaches the
    assembled tree as `extensions.plan`. Capture is observation-only —
    response `data` bytes are identical with the flag on or off
    (golden-corpus-enforced, tests/test_explain.py)."""
    prof = QueryProfile(debug=debug)
    if debug:
        METRICS.inc("explain_queries_total")
    token = _PROFILE.set(prof)
    before = {k: METRICS.value(k) for k in _PROFILE_EVENT_KEYS}
    k0 = None
    v0 = None
    try:
        from dgraph_tpu_torch.ops import packed_setops

        k0 = packed_setops.counters()
    except Exception:
        pass
    try:
        from dgraph_tpu_torch.models import vector as _vec

        v0 = _vec.counters()
    except Exception:
        pass
    try:
        yield prof
    finally:
        _PROFILE.reset(token)
        prof.events = {
            k: METRICS.value(k) - before[k] for k in _PROFILE_EVENT_KEYS
        }
        if k0 is not None:
            try:
                from dgraph_tpu_torch.ops import packed_setops

                k1 = packed_setops.counters()
                prof.kernel = {
                    k: k1[k] - k0.get(k, 0)
                    for k in k1
                    if isinstance(k1[k], (int, float))
                }
            except Exception:
                pass
        if v0 is not None:
            # vector kernel timings itemized next to the setop counters
            # (same per-thread-delta caveat as above)
            try:
                from dgraph_tpu_torch.models import vector as _vec

                v1 = _vec.counters()
                for k in v1:
                    if isinstance(v1[k], (int, float)):
                        d = v1[k] - v0.get(k, 0)
                        if d:
                            prof.kernel[f"vec_{k}"] = d
            except Exception:
                pass


# ---------------------------------------------------------------------------
# Slow-query log
# ---------------------------------------------------------------------------


class SlowQueryLog:
    """Bounded JSONL log: append-only until `max_records`, then the file
    is rewritten keeping the newest `max_records // 2` lines. Trimming
    to HALF (not to the cap) amortizes the rewrite: without hysteresis
    every append past the cap would re-read and rewrite the whole file
    on the query path — exactly during a slow-query burst."""

    def __init__(self, path: str, max_records: int = 1000):
        self.path = path
        self.max_records = max(1, int(max_records))
        self._lock = threading.Lock()
        self._count = 0
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._count = sum(1 for _ in f)
            except OSError:
                self._count = 0

    def append(self, record: dict) -> None:
        with self._lock:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
            self._count += 1
            if self._count > self.max_records:
                keep = max(1, self.max_records // 2)
                with open(self.path) as f:
                    lines = f.read().splitlines()[-keep:]
                with open(self.path, "w") as f:
                    f.write("\n".join(lines) + "\n")
                self._count = len(lines)


_SLOW_LOG: Optional[SlowQueryLog] = None
_SLOW_LOG_PATH: Optional[str] = None
_SLOW_LOG_LOCK = threading.Lock()


def slow_query_log() -> Optional[SlowQueryLog]:
    """The process slow-query log, or None when DGRAPH_TPU_SLOW_QUERY_LOG
    is unset. Re-resolved when the knob changes (tests)."""
    global _SLOW_LOG, _SLOW_LOG_PATH
    from dgraph_tpu_torch.x import config

    path = config.get("SLOW_QUERY_LOG")
    if not path:
        return None
    with _SLOW_LOG_LOCK:
        if _SLOW_LOG is None or _SLOW_LOG_PATH != path:
            _SLOW_LOG = SlowQueryLog(
                path, int(config.get("SLOW_QUERY_LOG_MAX"))
            )
            _SLOW_LOG_PATH = path
        return _SLOW_LOG


def maybe_log_slow(
    kind: str, text: str, took_ms: float, root_span=None,
    extra: Optional[dict] = None, tracer: Optional[Tracer] = None,
    threshold_ms: Optional[float] = None,
) -> bool:
    """Slow-operation hook for the query/commit entry points: when
    `took_ms` exceeds DGRAPH_TPU_SLOW_QUERY_MS (or the explicit
    `threshold_ms` override), force-sample the trace (retro-export its
    buffered spans) and append a record — query text, latency, trace
    id, and the full LOCAL span tree — to the bounded slow-query JSONL
    log (falls back to a logging warning when no log path is
    configured). Returns True when the operation was slow."""
    from dgraph_tpu_torch.x import config

    limit = (
        float(config.get("SLOW_QUERY_MS"))
        if threshold_ms is None
        else float(threshold_ms)
    )
    if took_ms <= limit:
        return False
    METRICS.inc("slow_queries_total")
    tr = tracer or TRACER
    tid = int(getattr(root_span, "trace_id", 0) or 0)
    if tid:
        tr.force_sample(tid)
    record = {
        "ts": time.time(),
        "kind": kind,
        "took_ms": round(took_ms, 2),
        "trace_id": f"{tid:032x}",
        "query": text[:2000],
        "spans": tr.trace_spans(tid) if tid else [],
    }
    if _exemplars_enabled():
        # close the metrics→trace loop from the log side too: the
        # latency histogram's current exemplars (one (value, trace_id)
        # anchor per bucket) ride along with the slow record, so a
        # reader can jump from the log to the traces anchoring the
        # distribution this query landed in
        name = (
            "commit_latency_seconds"
            if kind == "commit"
            else "query_latency_seconds"
        )
        record["exemplars"] = METRICS.exemplars(name)
    if extra:
        record.update(extra)
    log = slow_query_log()
    if log is not None:
        log.append(record)
    else:
        import logging

        logging.getLogger("dgraph_tpu.slow").warning(
            "slow %s: %.1fms trace=%032x %s",
            kind, took_ms, tid, text[:500].replace("\n", " "),
        )
    return True


# ---------------------------------------------------------------------------
# Per-process debug HTTP server (/debug/prometheus_metrics, /debug/traces)
# ---------------------------------------------------------------------------


def start_debug_http(host: str = "127.0.0.1", port: int = 0):
    """Serve this process's metrics + traces over HTTP — every alpha and
    zero process runs one (the reference exposes the same paths on each
    instance; the facade's merged endpoint scrapes them). Returns
    (server, bound_port)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _DebugHandler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, data: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/debug/prometheus_metrics":
                self._send(METRICS.render().encode(), "text/plain")
            elif self.path == "/debug/openmetrics":
                self._send(
                    METRICS.render_openmetrics().encode(),
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8",
                )
            elif self.path.startswith("/debug/traces"):
                self._send(
                    json.dumps({"spans": TRACER.recent(200)}).encode(),
                    "application/json",
                )
            elif self.path == "/debug/tablets":
                TABLETS.publish()
                self._send(
                    json.dumps(
                        {"tablets": TABLETS.snapshot()}
                    ).encode(),
                    "application/json",
                )
            elif self.path.startswith("/debug/digests"):
                from dgraph_tpu_torch.serving.digest import DIGESTS

                self._send(
                    json.dumps(
                        {"digests": DIGESTS.snapshot()}
                    ).encode(),
                    "application/json",
                )
            elif self.path.startswith("/debug/history"):
                from urllib.parse import parse_qs, urlparse

                qs = parse_qs(urlparse(self.path).query)
                try:
                    window = float(qs.get("window", ["600"])[0])
                except ValueError:
                    window = 600.0
                self._send(
                    json.dumps(HISTORY.report(window)).encode(),
                    "application/json",
                )
            elif self.path.startswith("/debug/profile"):
                from urllib.parse import parse_qs, urlparse

                from dgraph_tpu_torch.utils.profiler import AUTO, PROFILER

                qs = parse_qs(urlparse(self.path).query)
                if qs.get("last"):
                    folded = AUTO.last() or ""
                    self._send(
                        folded.encode(), "text/plain",
                        200 if folded else 404,
                    )
                else:
                    try:
                        seconds = float(qs.get("seconds", ["5"])[0])
                    except ValueError:
                        seconds = 5.0
                    folded = PROFILER.profile(
                        min(max(seconds, 0.05), 60.0)
                    )
                    self._send(folded.encode(), "text/plain")
            elif self.path.startswith("/debug/slowlog"):
                log = slow_query_log()
                body = b""
                if log is not None:
                    try:
                        with open(log.path, "rb") as f:
                            body = f.read()
                    except OSError:
                        body = b""
                self._send(body, "application/x-ndjson")
            elif self.path == "/debug/config":
                from dgraph_tpu_torch.x import config as _cfg

                self._send(
                    json.dumps(_cfg.resolved(), default=str).encode(),
                    "application/json",
                )
            elif self.path in ("/healthz", "/debug/healthz"):
                self._send(
                    json.dumps(healthz()).encode(), "application/json"
                )
            else:
                self._send(b"not found", "text/plain", 404)

    srv = ThreadingHTTPServer((host, port), _DebugHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def attach_debug_surface(rpc_server):
    """Give an alpha/zero RpcServer the observability surface: the
    debug.metrics / debug.traces / debug.info RPC methods (what the
    facade scrapes and merges) and — unless DGRAPH_TPU_DEBUG_HTTP=0 —
    the per-process HTTP listener serving /debug/prometheus_metrics and
    /debug/traces on an ephemeral port (advertised via debug.info).
    Returns (http_server_or_None, port)."""
    from dgraph_tpu_torch.x import config

    srv, port = (None, 0)
    if bool(config.get("DEBUG_HTTP")):
        srv, port = start_debug_http()
    info = {
        "instance": rpc_server.instance,
        "debug_http_port": port,
        "pid": os.getpid(),
    }
    rpc_server.register(
        "debug.metrics",
        lambda a: {
            "text": METRICS.render(),
            "instance": rpc_server.instance,
        },
    )
    rpc_server.register(
        "debug.traces",
        lambda a: {"spans": TRACER.recent(int((a or {}).get("n", 200)))},
    )

    def _tablets(a):
        TABLETS.publish()
        return {
            "tablets": TABLETS.snapshot(),
            "instance": rpc_server.instance,
        }

    rpc_server.register("debug.tablets", _tablets)
    rpc_server.register(
        "debug.health", lambda a: healthz(rpc_server.instance)
    )

    def _digests(a):
        from dgraph_tpu_torch.serving.digest import DIGESTS

        return {
            "digests": DIGESTS.snapshot(),
            "instance": rpc_server.instance,
        }

    rpc_server.register("debug.digests", _digests)
    rpc_server.register(
        "debug.history",
        lambda a: dict(
            HISTORY.report(float((a or {}).get("window", 600.0))),
            instance=rpc_server.instance,
        ),
    )
    rpc_server.register("debug.info", lambda a: dict(info))
    return srv, port


# ---------------------------------------------------------------------------
# metric declarations (one line of doc per name; keep alphabetical per
# kind — METRICS.md is generated from this table)
# ---------------------------------------------------------------------------

declare_metric(
    "counter", "admission_degraded_total",
    "Queries admitted in degraded mode (bounded budget, partial "
    "response) because the slow-query signal or exec-pool backpressure "
    "said the server was saturated (serving/admission.py).",
)
declare_metric(
    "counter", "admission_shed_total",
    "Queries refused fast with too_many_requests because the in-flight "
    "cost budget (DGRAPH_TPU_MAX_INFLIGHT) was exhausted.",
)
declare_metric(
    "counter", "apply_shard_batches_total",
    "Group-commit batches whose columnar write-set was encoded by the "
    "multi-process apply plane (worker/applyshard.py): columns "
    "partitioned by (namespace, predicate), shipped over per-worker "
    "shared-memory rings, kernels run in apply-shard worker processes "
    "outside the serving GIL, results merged in shard-index order.",
)
declare_metric(
    "counter", "apply_shard_fallback_total",
    "Batches that escaped the multi-process apply plane back to the "
    "in-process kernel (exact serial semantics preserved) — worker "
    "crash/timeout, ring overflow, or the sticky disable after "
    "repeated strikes. Per-cause split in the "
    'apply_shard_fallback_total{reason="*"} family.',
)
declare_metric(
    "counter", 'apply_shard_fallback_total{reason="*"}',
    "Per-reason split of apply_shard_fallback_total (crash, timeout, "
    "ring_full, error, spawn, sticky — see worker/applyshard.py call "
    "sites).",
)
declare_metric(
    "counter", "apply_shard_ipc_seconds",
    "Wall seconds group-commit leaders spent shipping columns into "
    "the shared-memory rings and waiting on apply-shard worker "
    "responses — the shard-IPC cost qps_loadgen stamps into "
    "BENCH_QPS rows (compare against commit_propose_ns_total for the "
    "IPC share of the propose phase).",
)
declare_metric(
    "counter", "backup_bytes_total",
    "Uncompressed record-payload bytes written into backup chunk "
    "files (admin/backup.py BackupWriter).",
)
declare_metric(
    "counter", "backup_files_total",
    "Backup chunk files committed into manifest entries.",
)
declare_metric(
    "counter", "backup_move_races_total",
    "Tablet captures retried because an ownership flip raced the copy "
    "stream (worker/backupdriver.py): the buffered records were "
    "discarded and the tablet re-streamed from its new owner, so it "
    "lands in the backup exactly once.",
)
declare_metric(
    "counter", "backup_moves_waited_total",
    "Tablets whose backup capture waited out an in-flight move "
    "(zero.moves_hint drain) before streaming.",
)
declare_metric(
    "counter", "backup_records_total",
    "KV version records written into committed backups.",
)
declare_metric(
    "counter", "backup_resumed_total",
    "Journaled in-flight backups resumed after a coordinator crash "
    "(worker/backupdriver.py BackupJournal).",
)
declare_metric(
    "counter", "batch_coalesced_total",
    "Member (predicate, level) tasks coalesced into multi-query "
    "micro-batch dispatches (serving/microbatch.py); solo dispatches "
    "do not count.",
)
declare_metric(
    "counter", "cdc_backpressure_waits_total",
    "Commits that blocked on a full CDC event queue "
    "(DGRAPH_TPU_CDC_QUEUE_MAX) until the sink emitter drained — the "
    "bounded-queue backpressure contract (admin/cdc.py).",
)
declare_metric(
    "counter", "cdc_events_total",
    "CDC events delivered to the sink (file and/or callback), "
    "including replays; dedup downstream on (commit_ts, seq).",
)
declare_metric(
    "counter", "cdc_replayed_events_total",
    "CDC events re-emitted by replay-from-checkpoint (KV versions "
    "above the durable checkpoint scanned at startup/failover — the "
    "sink-crash loss-window closer, admin/cdc.py).",
)
declare_metric(
    "counter", "cdc_sink_retries_total",
    "CDC sink deliveries retried after a sink failure "
    "(conn/retry.RetryPolicy backoff in the emitter thread).",
)
declare_metric(
    "counter", "circuit_close_total",
    "Peer circuits closed after a successful probe/call.",
)
declare_metric(
    "counter", "circuit_failfast_total",
    "Calls refused fast because the peer's circuit was open.",
)
declare_metric(
    "counter", "circuit_halfopen_probes_total",
    "Trial calls admitted through an open circuit (half-open probes).",
)
declare_metric(
    "counter", "circuit_open_total",
    "Peer circuits opened after max_misses consecutive failures.",
)
declare_metric(
    "counter", "degraded_group_reads_total",
    "Reads answered EMPTY because the owning group was unreachable "
    "(partial_ok query path).",
)
declare_metric(
    "counter", "degraded_queries_total",
    "Queries that returned a degraded/partial response.",
)
declare_metric(
    "counter", "digest_evicted_total",
    "Digest-store rows evicted past DGRAPH_TPU_DIGEST_SHAPES and "
    "folded into the sticky per-namespace `other` bucket "
    "(serving/digest.py) — totals stay exact under shape churn.",
)
declare_metric(
    "counter", "exec_parallel_siblings",
    "Sibling subtrees submitted to the parallel executor pool.",
)
declare_metric(
    "counter", "explain_queries_total",
    "Queries served with the debug (EXPLAIN/ANALYZE) flag: the "
    "PlanCapture hooks were live and extensions.plan was assembled "
    "(utils/observe.py profile_scope).",
)
declare_metric(
    "counter", "fault_*_total",
    "Fault injections by action (drop/delay/dup/disconnect/partition).",
)
declare_metric(
    "counter", "faults_injected_total",
    "Total fault-plan injections across all fault points.",
)
declare_metric(
    "counter", "frame_oversize_total",
    "Frames rejected for exceeding DGRAPH_TPU_MAX_FRAME_BYTES "
    "(send-side refusals + corrupt receive headers).",
)
declare_metric(
    "counter", "group_unavailable_failfast_total",
    "Group reads refused fast because every replica circuit was open.",
)
declare_metric(
    "counter", "follower_reads_total",
    "Group reads served by a replica other than the known leader under "
    "the watermark-verification rule (worker/remote.py follower "
    "routing + worker/groups.py read_replica): the serving replica's "
    "applied index covered the group's read floor, so the bytes are "
    "provably identical to a leader-served read at the same ts.",
)
declare_metric(
    "counter", "follower_read_floor_unknown_skips_total",
    "Follower candidates skipped because the group's read floor is "
    "still UNKNOWN (worker/replicapick.py, worker/groups.py): a "
    "freshly started/restarted coordinator serves leader-only until a "
    "leader health reply or completed proposal establishes a real "
    "floor — floor 0 would otherwise cover pre-restart writes.",
)
declare_metric(
    "counter", "follower_read_stale_skips_total",
    "Follower candidates the picker skipped because their cached "
    "applied index was stale/unknown or below the group's read floor "
    "(worker/replicapick.py) — stale-or-unknown never serves.",
)
declare_metric(
    "counter", "hedge_fired_total",
    "Hedged reads that raced a second replica.",
)
declare_metric(
    "counter", "hedge_skipped_saturated_total",
    "Hedges skipped because all shared hedge-pool workers were busy "
    "(worker/remote.py): a queued hedge would fire after its own "
    "deadline and only waste a replica read, so saturation degrades to "
    "the primary (or a sequential rotation on the calling thread).",
)
declare_metric(
    "counter", "hedge_losses_joined",
    "Losing hedge futures reaped via done-callbacks (never abandoned).",
)
declare_metric(
    "counter", "hedge_wins",
    "Reads won by a request the hedge timer launched (worker/remote.py"
    " _hedged_rotation). Plain failure rotations never count, so "
    "hedge_wins <= hedge_fired_total and the ratio measures hedge "
    "effectiveness.",
)
declare_metric(
    "counter", "history_snapshots_total",
    "Metrics-history snapshots taken by the background sampler "
    "(utils/observe.py MetricsHistory) — in-memory ring appends; the "
    "on-disk ring mirrors them when DGRAPH_TPU_HISTORY_DIR is set.",
)
declare_metric(
    "counter", "history_disk_rotations_total",
    "On-disk history-ring rotations: the log exceeded "
    "DGRAPH_TPU_HISTORY_DISK_MAX_BYTES and was rewritten keeping the "
    "newest half of its records.",
)
declare_metric(
    "counter", "idem_hits_total",
    "Requests answered from the server idempotency LRU (retransmits).",
)
declare_metric(
    "counter", "idem_inflight_waits_total",
    "Retransmits that waited on the original in-flight execution.",
)
declare_metric(
    "counter", "level_batch_read_bytes",
    "Bytes of decoded posting data returned by batched level reads.",
)
declare_metric(
    "counter", "level_task_uids",
    "Parent uids covered by level tasks (fan-out width accounting).",
)
declare_metric(
    "counter", "level_tasks_started",
    "Vectorized (predicate, level) tasks started by the executor.",
)
declare_metric(
    "counter", "metrics_scrape_errors_total",
    "Per-instance scrape failures during cluster metrics aggregation.",
)
declare_metric(
    "counter", "group_commit_bypass_total",
    "Commits that took the adaptive group-commit bypass "
    "(worker/groupcommit.py): the width-EWMA said no batchmate was "
    "waiting and the coalescer was idle, so the committer ran the "
    "engine's serial path directly — skipping the condvar handoffs "
    "that lose to serial at batch width ~1.05. Disable with "
    "DGRAPH_TPU_GROUP_COMMIT_BYPASS=0.",
)
declare_metric(
    "counter", "group_commit_total",
    "Commit batches executed by the group-commit coalescer "
    "(worker/groupcommit.py): one oracle exchange + one bounded "
    "proposal per owning group per batch.",
)
declare_metric(
    "counter", "group_commit_txns_total",
    "Transactions committed through the group-commit coalescer "
    "(divide by group_commit_total for the realized batch width).",
)
declare_metric(
    "gauge", "commit_pipeline_depth",
    "Commit batches whose apply barrier is still outstanding — the "
    "group-commit pipeline's in-flight depth (proposals for the next "
    "batch overlap the previous batch's barrier).",
)
declare_metric(
    "histogram", "group_commit_batch_size",
    "Distribution of transactions coalesced per commit batch "
    "(count-valued buckets, capped by "
    "DGRAPH_TPU_GROUP_COMMIT_MAX_TXNS).",
)
declare_metric(
    "counter", "mutation_edges_total",
    "Postings written by committed transactions (data + index + "
    "reverse + count deltas) — the write path's edge throughput "
    "denominator.",
)
declare_metric(
    "counter", "mutation_batch_apply_total",
    "Native columnar batch_apply kernel invocations (posting/"
    "colwrite.py): one per group-commit batch (or serial commit) whose "
    "members collected columnar write sets.",
)
declare_metric(
    "counter", "mutation_batch_apply_edges_total",
    "Edges encoded through the native columnar batch_apply kernel — "
    "compare against mutation_native_fallback_total for kernel "
    "coverage of the write path.",
)
declare_metric(
    "counter", "mutation_native_fallback_total",
    "Edges (collect/apply stages) or keys (encode_deltas stage) that "
    "escaped the native mutation path to per-edge/per-key Python — "
    "the kernel-coverage regression signal. Per-cause split in the "
    'mutation_native_fallback_total{reason="*"} family.',
)
declare_metric(
    "counter", 'mutation_native_fallback_total{reason="*"}',
    "Per-reason split of mutation_native_fallback_total (delete, "
    "lang, facets, tok, deindex, mixed_txn, rich_posting, no_native, "
    "kernel, ... — see posting/colwrite.py and posting/pl.py call "
    "sites).",
)
declare_metric(
    "counter", "mutation_sharded_apply_total",
    "apply_edges calls whose Python-fallback edges were applied "
    "predicate-sharded across the exec-worker pool "
    "(posting/mutation.py _apply_edges_sharded).",
)
declare_metric(
    "counter", "commit_oracle_ns_total",
    "Wall time (ns) group-commit leaders spent in the oracle verdict "
    "exchange (fence check + zero.commit_batch) — the commit-phase "
    "split qps_loadgen stamps into BENCH_QPS rows.",
)
declare_metric(
    "counter", "commit_propose_ns_total",
    "Wall time (ns) group-commit leaders spent encoding deltas and "
    "dispatching write proposals (or the direct put_batch) — the "
    "commit-phase split qps_loadgen stamps into BENCH_QPS rows.",
)
declare_metric(
    "counter", "commit_apply_ns_total",
    "Wall time (ns) group-commit leaders spent in the apply barrier "
    "(group applies + watermark advance + zero.applied) — the "
    "commit-phase split qps_loadgen stamps into BENCH_QPS rows.",
)
declare_metric(
    "counter", "num_commits",
    "Committed transactions (reference x/metrics NumMutations analog).",
)
declare_metric(
    "counter", "num_queries",
    "Queries served (reference x/metrics NumQueries analog).",
)
declare_metric(
    "counter", "otlp_export_errors",
    "OTLP/HTTP batch posts that failed (collector unreachable).",
)
declare_metric(
    "counter", "otlp_spans_dropped",
    "Spans dropped because the OTLP export queue was full.",
)
declare_metric(
    "counter", "otlp_spans_exported",
    "Spans successfully posted to the OTLP collector.",
)
declare_metric(
    "counter", "plan_cache_hit_total",
    "Queries whose parsed plan was served from the plan cache "
    "(normalized-shape + literal-binding hit; parse skipped).",
)
declare_metric(
    "counter", "planner_reorders_total",
    "Evaluation-order decisions where the cost-based planner departed "
    "from declaration order (AND-filter chains ordered cheapest/most-"
    "selective first, var-free sibling expansion cheapest-first) — "
    "observation-equivalent by construction (query/planner.py).",
)
declare_metric(
    "counter", "profiler_auto_triggers_total",
    "Sampling-profiler captures auto-triggered by sustained SLO burn "
    "(utils/profiler.py): the 300s query burn rate exceeded "
    "DGRAPH_TPU_PROFILE_BURN at a history tick outside the cooldown.",
)
declare_metric(
    "counter", "profiler_samples_total",
    "Stack samples taken by the wall-clock sampling profiler across "
    "all captures (utils/profiler.py): one sys._current_frames() walk "
    "per sampled thread per tick.",
)
declare_metric(
    "counter", "pushdown_applied_total",
    "Traversal levels whose @filter was pushed below the fan-out: the "
    "planner evaluated the index-answerable filter tree rootless and "
    "intersected the ragged level rows directly, skipping the merged-"
    "frontier materialization and per-candidate verify "
    "(query/planner.py pushdown_candidates).",
)
declare_metric(
    "counter", "plan_cache_miss_total",
    "Plan-cache lookups that had to parse (new shape, new literal "
    "binding, epoch-invalidated entry, or cache disabled).",
)
declare_metric(
    "counter", "leaderless_reads_total",
    "Group reads served while the group had NO known leader: a "
    "watermark-verified follower answered anyway (worker/remote.py), "
    "surfaced to clients as the `degraded: leaderless` extension.",
)
declare_metric(
    "counter", "read_breaker_open_total",
    "Read-plane circuit breakers tripped OPEN: a replica hit "
    "DGRAPH_TPU_READ_BREAKER_ERRORS consecutive read failures and is "
    "skipped until a half-open probe succeeds (worker/replicapick.py).",
)
declare_metric(
    "counter", "read_breaker_close_total",
    "Read-plane breakers closed again: a half-open probe read "
    "succeeded and the replica rejoined the rotation.",
)
declare_metric(
    "counter", "read_breaker_probe_total",
    "Half-open probe reads admitted through an OPEN read-plane breaker "
    "(at most ~one per jittered DGRAPH_TPU_READ_BREAKER_PROBE_S window).",
)
declare_metric(
    "counter", "read_retry_budget_exhausted_total",
    "Reads refused because the query's shared retry/hedge RetryBudget "
    "ran dry (DGRAPH_TPU_READ_RETRY_BUDGET tokens per query) — "
    "surfaced as a retryable 503 so clients back off instead of the "
    "cluster retry-storming itself (conn/retry.py, worker/remote.py).",
)
declare_metric(
    "counter", "result_cache_hit_total",
    "Queries served whole from the snapshot-keyed result cache "
    "(serving/resultcache.py): byte-identical response bytes at an "
    "unchanged snapshot watermark, execution and encode skipped.",
)
declare_metric(
    "counter", "result_cache_miss_total",
    "Result-cache-eligible queries that executed (new binding, "
    "advanced watermark, TTL-expired or evicted entry).",
)
declare_metric(
    "counter", "restore_records_total",
    "Verified backup records replayed by restore/restore_to_cluster.",
)
declare_metric(
    "counter", "restore_verify_failures_total",
    "Backup files refused by restore verification (gzip corruption, "
    "sha256 mismatch, per-record CRC failure, record-count shortfall) "
    "— each one is a torn backup that would otherwise have replayed "
    "as a silent hole (admin/backup.py).",
)
declare_metric(
    "counter", "rpc_giveups_total",
    "RPC calls abandoned after exhausting retries/deadline.",
)
declare_metric(
    "counter", "rpc_refused_total",
    "RPC calls failed fast on connection refusal (peer down).",
)
declare_metric(
    "counter", "rpc_retries_total",
    "RPC attempt retries (reconnect-and-resend) across all peers.",
)
declare_metric(
    "counter", "rpc_server_requests_total",
    "Trace-context-carrying RPC requests served (rpc_server spans).",
)
declare_metric(
    "counter", "rpc_stale_responses_total",
    "Stale/duplicate responses skipped while matching request ids.",
)
declare_metric(
    "counter", "setop_block_bitmap_total",
    "Block pairs run through the word-wise bitmap AND/ANDNOT kernel "
    "(adaptive set-representation engine, ops/packed_setops.py).",
)
declare_metric(
    "counter", "setop_block_gallop_total",
    "Block pairs merged by the packed x packed galloping kernel "
    "(neither block bitmap-eligible; offsets merged without decode).",
)
declare_metric(
    "counter", "setop_block_probe_total",
    "Block pairs where a packed block (or array run) streamed against "
    "a bitmap container (O(1) membership probes).",
)
declare_metric(
    "counter", "setop_packed_total",
    "Set-op pairs routed to the compressed-domain (packed) kernels.",
)
declare_metric(
    "counter", "setop_pairs_total",
    "Set-op pairs dispatched (packed + decoded); with "
    "setop_packed_total this is the kernel-choice ratio.",
)
declare_metric(
    "counter", "slow_queries_total",
    "Operations exceeding DGRAPH_TPU_SLOW_QUERY_MS (force-sampled and "
    "appended to the slow-query log).",
)
declare_metric(
    "counter", "stream_encode_fallback_nodes_total",
    "Result blocks the streaming arena encoder handed back to the dict "
    "encoder (shapes the streaming composer does not replicate: "
    "@groupby, @normalize, facets, shortest-path, language fan-out) "
    "(query/streamjson.py).",
)
declare_metric(
    "counter", "stream_encode_native_bytes_total",
    "Response bytes emitted block-at-a-time by the native arena "
    "encoder kernels (enc_uid_objs/enc_int_objs in native/codec.cpp) "
    "instead of per-entity Python objects (query/streamjson.py).",
)
declare_metric(
    "counter", "tablet_fence_rejected_total",
    "Commits bounced with the retryable TabletFencedError because they "
    "touched a predicate inside a tablet move's Phase-2 fence "
    "(worker/tabletmove.py check_fences).",
)
declare_metric(
    "counter", "tablet_move_bytes_total",
    "Record bytes streamed into destination groups by tablet-move "
    "copy/delta chunks (worker/tabletmove.py).",
)
declare_metric(
    "counter", "tablet_move_chunks_total",
    "Bounded ('delta', chunk) proposals shipped by tablet moves "
    "(chunk size DGRAPH_TPU_MOVE_CHUNK_BYTES).",
)
declare_metric(
    "counter", "tablet_move_failed_total",
    "Tablet moves that aborted and rolled back (fence deadline "
    "overrun, unreachable group, ...); the journal guarantees the "
    "rollback completes even if the abort path itself dies.",
)
declare_metric(
    "counter", "tablet_move_recovered_total",
    "Journaled in-flight moves resolved by crash recovery "
    "(recover_moves): copy/fence phases rolled back, drop phase "
    "rolled forward to completion.",
)
declare_metric(
    "counter", "tablet_move_total",
    "Tablet moves completed end-to-end (copy + fence + flip + source "
    "drop + journal clear).",
)
declare_metric(
    "counter", "vector_probe_cells_total",
    "IVF cells probed across vector similar_to searches "
    "(models/vector.py).",
)
declare_metric(
    "counter", "vector_rerank_pool_total",
    "Candidates re-scored exactly in float32 after the quantized int8 "
    "scan (models/vector.py _rerank; pool size is VEC_RERANK * k).",
)
declare_metric(
    "counter", "vector_search_total",
    "Vector similar_to queries served by the vector engine, any tier "
    "(quantized or jitted, brute or IVF) (models/vector.py).",
)
declare_metric(
    "gauge", "vector_index_build_seconds",
    "Wall seconds of the last vector index build on this process "
    "(centroid train + assignment + layout) — incremental mutations "
    "never restamp it, so movement here means a real rebuild "
    "(models/vector.py).",
)
declare_metric(
    "gauge", "admission_inflight_queries",
    "Queries currently in flight past the admission gate (tracked even "
    "with DGRAPH_TPU_ADMISSION=0; the micro-batcher's idle signal).",
)
declare_metric(
    "gauge", "cdc_emitter_dead",
    "1 when the CDC sink-emitter thread has died (sink crash, or a "
    "failure that survived close-time retries): committed events are "
    "deferred to replay-from-checkpoint until CDC is re-enabled — "
    "alert on this, the stream is not flowing (admin/cdc.py).",
)
declare_metric(
    "gauge", "cdc_checkpoint_ts",
    "Durable CDC checkpoint commit-ts (replicated through the group "
    "raft log on clusters; KV-resident on a single Server) — replay "
    "after a crash/failover resumes above this (admin/cdc.py).",
)
declare_metric(
    "gauge", "cdc_queue_depth",
    "CDC events currently buffered between the commit paths and the "
    "sink-emitter thread (bounded by DGRAPH_TPU_CDC_QUEUE_MAX).",
)
declare_metric(
    "gauge", "cache_batch_read_keys",
    "Keys covered by batched LocalCache reads (READ_COUNTERS mirror).",
)
declare_metric(
    "gauge", "cache_batch_reads",
    "Batched LocalCache read calls (READ_COUNTERS mirror).",
)
declare_metric(
    "gauge", "cache_point_reads",
    "Point LocalCache reads (READ_COUNTERS mirror).",
)
declare_metric(
    "gauge", "digest_shapes",
    "Distinct (namespace, shape) rows currently tracked by this "
    "process's query digest store (serving/digest.py; published at "
    "scrape time like tablet_traffic_tablets).",
)
declare_metric(
    "gauge", "history_samples",
    "Snapshots currently retained in this process's in-memory metrics "
    "history ring (bounded by DGRAPH_TPU_HISTORY_RETENTION).",
)
declare_metric(
    "gauge", "profiler_active",
    "1 while a sampling-profiler capture is running on this process "
    "(on-demand or auto-triggered), else 0.",
)
declare_metric(
    "gauge", "tablet_traffic_tablets",
    "Distinct (namespace, predicate) tablets tracked by this process's "
    "traffic accumulator (utils/observe.py TabletTraffic; per-tablet "
    "rows ride the /debug/tablets JSON surface, not the exposition).",
)
declare_metric(
    "gauge", "exec_pool_queue_depth",
    "Sibling-expansion tasks submitted to the bounded exec-worker pool "
    "but not yet running — the pool's real backpressure, read by "
    "admission control and surfaced in the per-query profile "
    "(query/subgraph.py).",
)
declare_metric(
    "histogram", "commit_latency_seconds",
    "End-to-end commit latency at the entry point.",
)
declare_metric(
    "histogram", "query_latency_seconds",
    "End-to-end query latency at the entry point.",
)
declare_metric(
    "histogram", "tablet_move_fence_seconds",
    "Duration of tablet-move Phase-2 fences (moving state + delta "
    "catch-up + flip, under the commit lock) — the only window a move "
    "blocks commits, bounded by DGRAPH_TPU_MOVE_FENCE_DEADLINE_S.",
)
declare_metric(
    "histogram", "span_*_seconds",
    "Per-span-name duration distributions (query/commit/level_task/"
    "rpc_server/...), fed by the tracer on every span finish.",
)
