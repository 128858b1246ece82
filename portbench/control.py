"""The control of a cell's `correct`: its reference put in the program's
place, one precision down (or, where the configuration states no
precision, with one of its guarantees broken), checked as a run checks
the program's answers. It must come out not correct.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 [--device cuda]

From the root of a checkout. Prints one JSON line a seed with the
compared numbers and their limits. The benchmark's runs do not run it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(cell, seed: int, device: str, log=print) -> dict:
    """The control's compared numbers for one seed: each kind's sample of
    reads answered by its `control`, then judged by its `check`."""
    system = cell.system()
    data = system.generate(cell.config, seed, device, log)
    out = {}
    for kind in cell.traffic["mix"]:
        mod = cell.read_kind(kind["read"])
        n = int(kind["sample"])
        args = [arg for _, arg in mod.prepare(data, kind, seed, n)]
        answers = mod.control(data, kind, args, device)
        for name, value in mod.check(data, kind, list(zip(args, answers)), device).items():
            out[name] = {"value": value, "limit": mod.LIMITS[name]}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from portbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), a.workload, ROOT)
    for seed in a.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, a.device, harness.log)
        fails = any(c["value"] > c["limit"] for c in nums.values())
        print(json.dumps({"workload": a.workload, "seed": seed, "control_fails": fails,
                          "numbers": nums, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
