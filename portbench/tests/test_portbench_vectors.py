"""The vector cell `vec1m768.similar10`: its configuration, traffic, read
kind and metrics are found by name, and at a tiny size on a CPU `Server`
it runs correct through the harness, on the brute and the IVF tier; its
controls (the reference answering from half the commits, and the IVF
probing one cell) and an altered answer come out not correct."""

import json

import numpy as np
import pytest

from portbench import harness
from portbench.control import control_numbers
from portbench.tests import _tiny

NAME = "vec1m768.similar10"
METRICS = ("vector_search_ms", "vector_rows_per_read", "ivf_train_s", "ivf_scan_roofline",
           "vector_topk_roofline")
TINY = {"rows": 6000, "dim": 64, "clusters": 12, "manifold_dim": 8, "manifold_sigma": 1.0,
        "queries": 120, "block": 2000}


@pytest.fixture(autouse=True)
def float_paths(monkeypatch):
    """The card's paths on the CPU: the float scans, not the quantized."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")


def cell(root, **config):
    c = harness.Cell(_tiny.spec(root), NAME, root)
    c.config.update(TINY, **config)
    c.traffic.update(pool=60, warmup_per_client=4)
    for kind in c.traffic["mix"]:
        kind["sample"] = 40
    return c


def ivf_tier(ctx):
    """The index built with a threshold a tiny corpus passes: its next
    search builds the IVF tier."""
    idx = ctx.state.server.vector_indexes["emb"]
    idx.ivf_threshold = 1000
    idx._dirty = True


def run(root, trace=False, after_load=None, seed=987654321123, keep=False, **config):
    """One tiny run; `keep` adds the run's vector index to the result."""
    c = cell(root, **config)
    if not trace:
        c.per_layer = []
    kept = {}

    def then(ctx):
        kept["index"] = ctx.state.server.vector_indexes["emb"]
        if after_load is not None:
            after_load(ctx)

    r = harness.run(c, seed, 1.5, trace, "cpu", after_load=then)
    if keep:
        r["index"] = kept["index"]
    return r


def test_files_are_found_by_name(root):
    c = harness.Cell(_tiny.spec(root), NAME, root)
    assert c.chips == 1 and c.config["system"] == "vectors"
    assert c.config["reduced"] == [] and c.config["rows"] == 1_000_000
    assert c.traffic["clients"] == 1 and c.traffic["pool"] == 1000
    assert [k["read"] for k in c.traffic["mix"]] == ["similar10"]
    mod = c.read_kind("similar10")
    assert set(mod.LIMITS) == {"recall_loss", "size_errors"}
    assert {m["name"] for m in c.end_to_end} == {"qps", "setup_s"}
    mine = {m["name"] for m in c.per_layer}
    assert set(METRICS) <= mine
    for name in mine:
        assert callable(c.metric(name).read)


@pytest.mark.parametrize("tier", ["brute", "ivf"])
def test_tiny_cell_is_correct(root, tier):
    r = run(root, after_load=ivf_tier if tier == "ivf" else None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"qps", "setup_s"}
    assert set(r["checks"]) == {"recall_loss", "size_errors", "failed_reads"}


def test_traced_run_reads_the_index_spans_and_counters(root):
    r = run(root, trace=True, after_load=ivf_tier, keep=True)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    # every read of the window probed the IVF tier's slabs, and none
    # scanned the corpus
    m = r["index"]._ivf["m_slabs"]
    assert got["vector_rows_per_read"]["value"] == m * 128 < TINY["rows"]
    assert got["vector_search_ms"]["value"] > 0
    assert got["ivf_train_s"]["value"] > 0
    # a CPU run has no device trace: the rooflines read nothing
    assert "ivf_scan_roofline" not in got and "vector_topk_roofline" not in got


def test_metrics_read_nothing_where_the_program_counts_nothing(root, monkeypatch):
    """Tracing off: no span lands in a histogram, so the span metrics are
    left out of the line, as on a program without the spans."""
    from dgraph_tpu_torch.utils.observe import METRICS

    monkeypatch.setenv("DGRAPH_TPU_TRACE", "0")
    # the histograms as a fresh process has them: an earlier test's
    # spans are not this run's
    monkeypatch.setattr(METRICS, "_hists", {})
    r = run(root, trace=True, after_load=ivf_tier)
    assert r["correct"], r["checks"]
    assert "vector_search_ms" not in r["metrics"] and "ivf_train_s" not in r["metrics"]


def test_control_is_not_correct(root):
    """The reference answering from the rows of half the commits misses
    neighbours past the recall limit."""
    c = cell(root)
    for seed in (1, 2, 3):
        nums = control_numbers(c, seed, "cpu", lambda m: None)
        assert nums["recall_loss"]["value"] > nums["recall_loss"]["limit"], (seed, nums)
        assert nums["size_errors"]["value"] == 0


def test_one_cell_probe_is_not_correct(root, monkeypatch):
    """The program's IVF tier probing one cell (`VEC_NPROBE=1`) misses
    neighbours past the recall limit."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_NPROBE", "1")
    # cells of a dozen slabs, a cluster over several, as at full size
    monkeypatch.setenv("DGRAPH_TPU_VEC_NLIST", "64")
    r = run(root, after_load=ivf_tier, rows=20000, clusters=4)
    assert not r["correct"]
    assert r["checks"]["recall_loss"]["value"] > r["checks"]["recall_loss"]["limit"], r["checks"]


@pytest.mark.parametrize("fault", ["drop", "extra", "relabel"])
def test_an_altered_answer_is_not_correct(root, fault):
    def alter(ctx):
        server = ctx.state.server
        real = server.query

        def altered(q, **kw):
            r = real(q, **kw)
            a = json.loads(r["data"].raw)
            got = a["q"]
            if fault == "drop":
                got.pop(0)
            elif fault == "extra":
                got.append(dict(got[0]))
            else:
                # a neighbour's uid given another row's id
                got[0]["id"] += 1
            r["data"].raw = json.dumps(a).encode()
            return r

        server.query = altered

    r = run(root, after_load=alter)
    assert not r["correct"]
    name = {"drop": "size_errors", "extra": "size_errors", "relabel": "recall_loss"}[fault]
    assert r["checks"][name]["value"] > r["checks"][name]["limit"], r["checks"]


def test_same_seed_same_data_other_seed_relabels_it(root):
    c = cell(root)
    system = c.system()
    a = system.generate(c.config, 424242424242, "cpu", lambda m: None)
    b = system.generate(c.config, 424242424242, "cpu", lambda m: None)
    o = system.generate(c.config, 7, "cpu", lambda m: None)
    np.testing.assert_array_equal(a.vecs, b.vecs)
    np.testing.assert_array_equal(a.queries, o.queries)
    assert not np.array_equal(a.vecs, o.vecs)
    # the same rows under other labels
    key = lambda v: v[np.lexsort(v.T[::-1])]  # noqa: E731
    np.testing.assert_array_equal(key(a.vecs), key(o.vecs))
    norms = np.linalg.norm(a.vecs, axis=1)
    assert 0.2 < norms.min() and norms.max() < 4.0 and 0.2 < norms.std() < 0.3
