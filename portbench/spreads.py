"""Medians and spreads of a cell's runs, as its bounds are set from them.

    python3 portbench/spreads.py set1.jsonl set2.jsonl ...

Each file is one set of runs: a result line a run (what run.py prints
last), each line optionally led by a tag and a space. Prints, for each
metric, each set's median and spread (the distance between the first and
third quartile over the median, `statistics.quantiles`), the widest
spread, and the bound five times it would give.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.stats import spread  # noqa: E402


def read_set(path: str) -> dict:
    values: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line[line.index("{"):])
            for name, m in r["metrics"].items():
                values.setdefault(name, []).append(m["value"])
    return values


def main(paths) -> int:
    sets = [read_set(p) for p in paths]
    for name in sorted(set().union(*sets)):
        row, widest = [], 0.0
        for s in sets:
            xs = s.get(name, [])
            if len(xs) >= 2:
                sp = spread(xs)
                widest = max(widest, sp)
                row.append(f"median {statistics.median(xs):.6g} spread {sp:.4f} (n={len(xs)})")
        print(f"{name}: " + "; ".join(row) + f"; widest {widest:.4f}, 5x {5 * widest:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
