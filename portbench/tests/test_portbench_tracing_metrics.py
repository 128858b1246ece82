"""The metrics that read the program's collector counters and route
spans (`gc_ms_per_read`, `setop_host_ms`): a number in a traced run of
the tiny cell, and nothing where the program has nothing for them."""

import gc

from portbench.tests import _tiny

NAMES = ("gc_ms_per_read", "setop_host_ms")


def test_traced_run_reads_the_collector_and_the_route_spans(root):
    r = _tiny.run(root, "ldbc-sf1.fof2", trace=True)
    assert r["correct"], r["checks"]
    got = {n: r["metrics"][n]["value"] for n in NAMES}
    assert got["gc_ms_per_read"] >= 0
    # every set op of a CPU dispatcher stays on the host
    assert 0 < got["setop_host_ms"] <= r["metrics"]["processing_ms"]["value"]


def test_nothing_to_read_leaves_them_out(root, monkeypatch):
    """Tracing off and no collector hook: no route span ends and no
    collection is counted, so neither metric is in the line."""
    from dgraph_tpu_torch.utils import hosttrace

    monkeypatch.setenv("DGRAPH_TPU_TRACE", "0")
    hooked = hosttrace.gc_hook_installed()
    if hooked:
        gc.callbacks.remove(hosttrace._on_gc)
    try:
        r = _tiny.run(root, "ldbc-sf1.fof2", trace=True)
    finally:
        if hooked:
            hosttrace.install_gc_hook()
    assert r["correct"], r["checks"]
    assert not set(NAMES) & set(r["metrics"])
