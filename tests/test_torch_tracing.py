"""The port's spans on torch.profiler's trace (utils/hosttrace.py).

- A read of the benchmark's friends-of-friends shape, run inside a
  profiler run under an outer range, leaves the stage spans of
  `Server.query`, the executor's `level_task` and the dispatcher's
  `setop_host` as nested host events, each starting within 1 ms of the
  tracer's own record of the span: the two share one clock.
- `extensions.server_latency` is read from the stage spans' durations,
  with tracing on and off.
- A full collection inside a traced read is a `gc.gen2` host event and
  counts in the `gc_gen2_*` counters once the read ends.
- The dispatcher opens one route span a set op, by the route it took.
- The repaired `Tracer.span` records what the JAX package's records.
"""

import gc

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from dgraph_tpu.utils import observe as ref_observe
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.query import dispatch
from dgraph_tpu_torch.utils import hosttrace, observe

SCHEMA = "id: int @index(int) .\nknows: [uid] @reverse ."
# the benchmark's fof2 read (portbench/reads/fof2.py)
FOF2 = ("{{ me as var(func: eq(id, [{sids}])) {{ f as knows }} "
        "var(func: uid(f)) {{ fof as knows @filter(NOT uid(me) AND NOT uid(f)) }} "
        "q(func: uid(fof)) {{ id }} "
        "n(func: uid(fof)) {{ count(uid) }} }}")
READ = FOF2.format(sids="1, 5, 9, 13, 17, 21, 25, 29")
STAGES = ("query", "parse", "admit", "execute", "encode", "level_task", "setop_host")


@pytest.fixture(scope="module")
def server():
    s = Server(device="cpu")
    s.alter(SCHEMA)
    rng = np.random.default_rng(21)
    n = 300
    lines = [f'<{hex(i + 1)}> <id> "{i}"^^<xs:int> .' for i in range(n)]
    for a in range(n):
        for b in rng.choice(n, 8, replace=False).tolist():
            if a != b:
                lines.append(f"<{hex(a + 1)}> <knows> <{hex(b + 1)}> .")
                lines.append(f"<{hex(b + 1)}> <knows> <{hex(a + 1)}> .")
    s.new_txn().mutate_rdf(set_rdf="\n".join(lines), commit_now=True)
    s.query(READ, want="raw")  # warm
    return s


class _Closed:
    """Every TimedSpan closed while it is installed, in closing order."""

    def __init__(self, monkeypatch):
        self.spans = []
        real = hosttrace.TimedSpan.close

        def close(sp):
            real(sp)
            self.spans.append(sp)

        monkeypatch.setattr(hosttrace.TimedSpan, "close", close)

    def named(self, *names):
        return [s for s in self.spans if s.name in names]

    def one(self, name):
        got = self.named(name)
        assert len(got) == 1, [s.name for s in self.spans]
        return got[0]


def _host_events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_are_host_events_on_the_profilers_clock(server):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            r = server.query(READ, want="raw")
    events = _host_events(prof)
    (outer,) = [e for e in events if e[0] == "outer"]
    ev = {name: sorted((e for e in events if e[0] == name), key=lambda e: e[1])
          for name in STAGES}
    for name in STAGES:
        assert ev[name], name
        assert all(_within(e, outer) for e in ev[name]), name
    (query,) = ev["query"]
    (execute,) = ev["execute"]
    for name in ("parse", "admit", "execute"):
        assert all(_within(e, query) for e in ev[name]), name
    for name in ("encode", "level_task", "setop_host"):
        assert all(_within(e, execute) for e in ev[name]), name
    # each host event starts where the tracer recorded its span start
    trace_id = int(r["extensions"]["trace_id"], 16)
    spans = sorted(observe.TRACER.trace_spans(trace_id), key=lambda s: s["start"])
    for name in STAGES:
        mine = [s for s in spans if s["name"] == name]
        assert len(mine) == len(ev[name]), name
        for s, e in zip(mine, ev[name]):
            assert abs(e[1] / 1e9 - s["start"]) < 1e-3, (name, e[1] / 1e9, s["start"])


@pytest.mark.parametrize("trace", ["1", "0"])
def test_server_latency_is_read_from_the_stage_spans(server, trace, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_TRACE", trace)
    closed = _Closed(monkeypatch)
    lat = server.query(READ, want="raw")["extensions"]["server_latency"]
    parse, admit, execute, encode, query = (
        closed.one(n) for n in ("parse", "admit", "execute", "encode", "query"))
    assert lat["parsing_ns"] == parse.duration_ns
    assert lat["assign_timestamp_ns"] == admit.duration_ns
    assert lat["encoding_ns"] == encode.duration_ns
    assert lat["processing_ns"] == execute.duration_ns - encode.duration_ns
    parts = (lat["parsing_ns"] + lat["assign_timestamp_ns"] + lat["processing_ns"]
             + lat["encoding_ns"])
    assert parts == lat["total_ns"] > 0
    # the stages lie one after another inside the read's root
    assert lat["total_ns"] <= query.duration_ns
    assert query.t0 <= parse.t0 < parse.t1 <= admit.t0 < admit.t1 <= execute.t0
    assert execute.t0 <= encode.t0 < encode.t1 <= execute.t1 <= query.t1
    assert (execute.trace_id != 0) == (trace == "1")


def test_a_full_collection_in_a_read_is_a_host_event_and_counted(server, monkeypatch):
    real = Server._query_parsed

    def collecting(self, *a, **kw):
        gc.collect(2)
        return real(self, *a, **kw)

    monkeypatch.setattr(Server, "_query_parsed", collecting)
    assert hosttrace.gc_hook_installed()
    hosttrace.publish_gc()
    n0 = observe.METRICS.value("gc_gen2_collections_total")
    s0 = observe.METRICS.value("gc_gen2_pause_seconds_total")
    gc.disable()  # no collection but the read's own
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            server.query(READ, want="raw")
    finally:
        gc.enable()
    events = _host_events(prof)
    (execute,) = [e for e in events if e[0] == "execute"]
    full = [e for e in events if e[0] == "gc.gen2"]
    assert len(full) == 1 and _within(full[0], execute)
    assert observe.METRICS.value("gc_gen2_collections_total") == n0 + 1
    assert observe.METRICS.value("gc_gen2_pause_seconds_total") > s0


def test_each_set_op_opens_one_route_span(monkeypatch):
    d = dispatch.SetOpDispatcher(device="cpu")
    a = np.arange(0, 400, 2, dtype=np.uint64)
    b = np.arange(0, 400, 3, dtype=np.uint64)
    closed = _Closed(monkeypatch)
    d.run_pairs("intersect", [(a, b)])
    sp = closed.one("setop_host")
    assert not closed.named("setop_device")
    assert sp.attrs["op"] == "intersect" and sp.attrs["route"] == "host_native"
    assert sp.attrs["words"] == len(a) + len(b) and sp.attrs["bytes"] == 8 * (len(a) + len(b))
    assert sp.attrs["min_total"] == d._min_total()

    # forced onto the device path (plain torch on the CPU)
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
    closed.spans.clear()
    got = d.run_pairs("intersect", [(a, b)])[0]
    assert np.array_equal(got, np.intersect1d(a, b))
    sp = closed.one("setop_device")
    assert not closed.named("setop_host")
    assert sp.attrs["route"] == "pairs" and sp.attrs["words"] == len(a) + len(b)

    # a union of rows against one operand goes through run_pairs: the
    # nested call opens no second span
    closed.spans.clear()
    rows = [a[:50], a[50:120], a[120:]]
    got = d.run_rows_vs_one("union", rows, b)
    assert all(np.array_equal(g, np.union1d(r, b)) for g, r in zip(got, rows))
    sp = closed.one("setop_device")
    assert not closed.named("setop_host")
    assert sp.attrs["route"] == "pairs"
    assert sp.attrs["words"] == sum(len(r) for r in rows) + len(b)


def _records(mod):
    """The span records of one nested set of calls on a fresh tracer,
    as its ring keeps them and as the spans it yielded say: names,
    parents by name, attributes, sampling, the record's keys."""
    tr = mod.Tracer()
    yielded = []
    with tr.span("read", ns=0) as a:
        with tr.span("stage", op="intersect", words=12) as b:
            pass
        with tr.span("stage", route="host_native") as c:
            with tr.span("leaf") as d:
                pass
        yielded += [a, b, c, d]

    def shape(recs):
        by_id = {r["span_id"]: r["name"] for r in recs if r["span_id"]}
        return [(r["name"], by_id.get(r["parent_id"]), r["attrs"], r["sampled"], sorted(r))
                for r in recs]

    return shape(tr.recent(10)), shape([s.to_dict() for s in yielded]), yielded


@pytest.mark.parametrize("trace", ["1", "0"])
def test_repaired_span_records_as_the_reference_does(trace, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_TRACE", trace)
    assert not hosttrace.active()
    ring, yielded, spans = _records(observe)
    assert (ring, yielded) == _records(ref_observe)[:2]
    assert len(ring) == (4 if trace == "1" else 0) and len(yielded) == 4
    # the port's spans are stamped at both ends with the tracer on or off
    assert all(s.end >= s.start and s.t1 >= s.t0 for s in spans)
