"""Run one cell of the port's benchmark once, on the card this machine has.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is the
result, one JSON object; the compared numbers, each beside its limit,
are the last lines of standard error. Exits 2 without a result where
there is no card or fewer than the cell asks for. See README.md.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """This process's start on the `time.time()` clock, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.main(a.workload, a.seed, a.seconds, bool(a.trace), root=ROOT,
                        t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
