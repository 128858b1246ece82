"""Each cell's traffic and reference at a tiny size on a CPU `Server`,
driven through the harness as a run drives them (the measured command
itself needs a card); its control and the fault it can have must come
out not correct."""

import json

import pytest

from portbench import harness
from portbench.control import control_numbers
from portbench.tests import _tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_cell_is_correct_with_its_end_to_end_metrics(root, name):
    r = _tiny.run(root, name)
    assert r["correct"], r["checks"]
    assert list(r)[: len(KEYS)] == KEYS and list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    cell = _tiny.cell(root, name)
    assert sorted(r["metrics"]) == sorted(m["name"] for m in cell.end_to_end)
    for m in cell.end_to_end:
        assert r["metrics"][m["name"]]["unit"] == m["unit"]
        assert r["metrics"][m["name"]]["value"] > 0
    json.loads(json.dumps(r))


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_traced_run_reports_its_per_layer_metrics(root, name):
    r = _tiny.run(root, name, trace=True)
    assert r["correct"], r["checks"]
    cell = _tiny.cell(root, name)
    # host-side metrics read something on the CPU; a count of device
    # launches reads 0 there
    want = {m["name"] for m in cell.per_layer}
    assert want <= set(r["metrics"]), want - set(r["metrics"])
    assert set(r["device"]) >= {"busy_s", "window_s"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_control_is_not_correct(root, name):
    cell = _tiny.cell(root, name)
    for seed in (11, 12, 13):
        nums = control_numbers(cell, seed, "cpu", lambda m: None)
        assert any(c["value"] > c["limit"] for c in nums.values()), (seed, nums)


def _alter_graph_answer(ctx):
    """The served answer altered where the server produces it: the last
    id of every answer's first list changed."""
    server = ctx.state.server
    real = server.query

    def altered(q, **kw):
        r = real(q, **kw)
        a = json.loads(r["data"].raw)
        first = a.get("q") or []
        if first:
            first[-1]["id"] = first[-1]["id"] + 7
        r["data"].raw = json.dumps(a).encode()
        return r

    server.query = altered


def test_an_altered_answer_is_not_correct(root):
    r = _tiny.run(root, "ldbc-sf1.fof2", after_load=_alter_graph_answer)
    assert not r["correct"], r["checks"]


def test_a_failed_read_is_not_correct(root):
    def broken(ctx):
        server = ctx.state.server
        real = server.query
        calls = [0]

        def sometimes(q, **kw):
            calls[0] += 1
            if calls[0] == 40:
                raise RuntimeError("injected")
            return real(q, **kw)

        server.query = sometimes

    r = _tiny.run(root, "ldbc-sf1.fof2", after_load=broken)
    assert r["failed"] == 1 and not r["correct"]
    assert r["checks"]["failed_reads"]["value"] == 1


def test_same_seed_same_reads(root):
    cell = _tiny.cell(root, "ldbc-sf1.fof2")
    texts = []
    for _ in range(2):
        ctx = harness.Ctx(cell, 424242424242, 1.0, False)
        data = cell.system().generate(cell.config, 424242424242, "cpu", lambda m: None)
        harness.prepare(cell, ctx, data)
        texts.append([it.text for it in ctx.items])
    assert texts[0] == texts[1] and len(set(texts[0])) > 1
