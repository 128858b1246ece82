"""A configuration, a traffic mix and a metric added as files are found
by name, with no edit to the harness."""

import json
import os
import shutil

from portbench import harness


def test_new_files_are_found_by_name(tmp_path, root):
    shutil.copytree(os.path.join(root, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(root, "portbench/configs/ldbc-snb-sf1.json")) as f:
        conf = json.load(f)
    conf.update(name="ldbc-dummy", persons=300, knows_edges=2000)
    (tmp_path / "portbench/configs/ldbc-dummy.json").write_text(json.dumps(conf))
    (tmp_path / "portbench/traffic/dummy2hop.json").write_text(json.dumps({
        "clients": 2, "pool": 30, "warmup_per_client": 1,
        "mix": [{"read": "fof2", "share": 3, "sample": 10, "roots": 4, "control_stale_share": 0.1},
                {"read": "fof2", "share": 1, "sample": 10, "roots": 1,
                 "control_stale_share": 0.1}]}))
    (tmp_path / "portbench/metrics/dummy_reads.py").write_text(
        "def start(ctx):\n    ctx.store['dummy'] = 1\n\n\n"
        "def read(ctx):\n    return len(ctx.records) + ctx.store['dummy']\n")
    spec = {
        "configs": [{"name": "ldbc-dummy", "file": "portbench/configs/ldbc-dummy.json"}],
        "workloads": [{"name": "dummy.cell", "config": "ldbc-dummy", "traffic": "dummy2hop",
                       "chips": 1}],
        "end_to_end": [{"name": "dummy_reads", "unit": "reads"},
                       {"name": "qps", "unit": "reads/s", "workloads": ["other.cell"]}],
        "per_layer": [],
    }
    cell = harness.Cell(spec, "dummy.cell", str(tmp_path))
    assert [m["name"] for m in cell.end_to_end] == ["dummy_reads"]
    r = harness.run(cell, 5, 1.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["metrics"]["dummy_reads"]["value"] == r["attempted"] + 1
    kinds = {it.kind for it in harness.Ctx(cell, 5, 1.0, False).items} or None
    assert kinds is None
