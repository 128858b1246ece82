"""Cells cut to a size a CPU test run holds: the same files, the same
code, fewer rows and reads."""

import json
import os

from portbench import harness

TINY_CONFIG = {
    "ldbc-snb-sf1": {"persons": 600, "knows_edges": 6000},
}
TINY_TRAFFIC = {"clients": 4, "pool": 120, "warmup_per_client": 1}


def spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(root: str, name: str) -> harness.Cell:
    c = harness.Cell(spec(root), name, root)
    c.config.update(TINY_CONFIG[c.config["name"]])
    c.traffic.update(TINY_TRAFFIC)
    for kind in c.traffic["mix"]:
        kind["sample"] = min(int(kind["sample"]), 40)
    # a CPU run has no device trace
    c.per_layer = [m for m in c.per_layer if m["source"] != "device_trace"]
    return c


def run(root: str, name: str, seed: int = 987654321123, trace: bool = False, after_load=None,
        seconds: float = 2.0) -> dict:
    return harness.run(cell(root, name), seed, seconds, trace, "cpu", after_load=after_load)


CELLS = ("ldbc-sf1.fof2",)
