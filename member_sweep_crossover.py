#!/usr/bin/env python3
"""Where the member sweep's search regime starts to beat its stream regime.

    python3 member_sweep_crossover.py

The kernel (`dgraph_tpu_torch/csrc/member_sweep.cu`) picks a regime per
row: rows with LB >= search_from(LA) are searched, the others streamed.
This script builds two more copies of the kernel, with the rule's
constants replaced so that every row is searched or every row is
streamed, and times the three builds on the same rows: 256 MB of B per
point, LA queries against LB elements in every row, over a grid of
(LA, LB). The answers of all three must equal one batched
`torch.searchsorted`. Times are the kernel's device time from the card's
trace (`chip_smoke.kernel_device_ms`).

It prints one line per point and, per LA, the least LB from which
searching is no slower at every larger LB of the grid, and the time the
built-in rule loses against the faster regime, beside what the
reference's rule (LA * 32 <= LB) and a plain LA * 64 <= LB would lose.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import chip_smoke as cs

# the rule's constants in the source, and their values in each copy
RULE = ("constexpr int kSearchRatio = ", "constexpr int kSearchMinLB = ")
VARIANTS = {"search": (0, 0), "stream": (0, (1 << 31) - 1)}
LAS = (1, 4, 16, 32, 64, 128)
LBS = (128, 256, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384)
B_ELEMS = 1 << 26  # 256 MB of B per point


def build_variant(name, ratio, min_lb):
    """member_sweep.cu with the rule's constants replaced, built by nvcc
    into the port's build directory; returns the bound library."""
    from dgraph_tpu_torch.ops import cuda_build, member_sweep

    src = open(os.path.join(cuda_build.CSRC, "member_sweep.cu")).read()
    for key, value in zip(RULE, (ratio, min_lb)):
        at = src.index(key) + len(key)
        end = src.index(";", at)
        src = src[:at] + str(value) + src[end:]
    out = os.path.join(cuda_build.BUILD_DIR, "crossover")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, f"{name}.cu"), os.path.join(out, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    return member_sweep.bind(ctypes.CDLL(so))


def grid():
    for la in LAS:
        for lb in LBS:
            if 4 * la <= lb <= max(128 * la, 2048):
                yield la, lb


def main() -> int:
    import torch

    from dgraph_tpu_torch.ops import member_sweep

    if not torch.cuda.is_available():
        print("member_sweep_crossover: no CUDA card visible", file=sys.stderr)
        return 2
    card = cs.card_line()
    libs = {"rule": member_sweep._kernel()}
    libs.update({k: build_variant(k, *v) for k, v in VARIANTS.items()})
    print(f"device times in ms at {card}; 'rule' is the built kernel", flush=True)

    def run(lib, rows):
        member_sweep._lib = lib
        try:
            return member_sweep.membership_batch(*rows)
        finally:
            member_sweep._lib = libs["rule"]

    points = []
    for la, lb in grid():
        n = B_ELEMS // lb
        rows = cs.random_rows(n, la, lb, seed=la * 7 + lb, kind="full")
        A, LA, B, LB = rows
        want = cs.library_membership(cs._to_i64(A), LA, cs.sorted_keys(B, LB), LB)
        ms = {}
        for k, lib in libs.items():
            if not torch.equal(run(lib, rows), want):
                raise AssertionError(f"LA={la} LB={lb}: {k} build != searchsorted")
            ms[k] = cs.kernel_device_ms(lambda lib=lib: run(lib, rows), 10)
        rule = "search" if lb >= member_sweep.search_from(la) else "stream"
        points.append((la, lb, ms, rule))
        print(f"    LA={la} LB={lb} ({lb / la:g} LA) n={n}: searched {ms['search']:.6f} "
              f"streamed {ms['stream']:.6f} rule {ms['rule']:.6f} ({rule})", flush=True)
        del rows, A, LA, B, LB, want

    def loss(choose):
        """Worst and mean time lost against the faster regime, over the
        grid, when each point takes the regime `choose(la, lb)`."""
        lost = [ms[choose(la, lb)] / min(ms["search"], ms["stream"]) - 1
                for la, lb, ms, _ in points]
        return max(lost), sum(lost) / len(lost)

    for la in LAS:
        faster = [ms["search"] <= ms["stream"] for a, _, ms, _ in points if a == la]
        lbs = [lb for a, lb, _, _ in points if a == la]
        k = len(faster)
        while k and faster[k - 1]:
            k -= 1
        print(f"    LA={la}: searching is no slower from LB = "
              f"{lbs[k] if k < len(lbs) else 'none in the grid'} on "
              f"(the rule searches from {member_sweep.search_from(la)})", flush=True)
    rules = {
        "built-in rule": lambda la, lb: "search" if lb >= member_sweep.search_from(la) else "stream",
        "LA * 64 <= LB": lambda la, lb: "search" if 64 * la <= lb else "stream",
        "LA * 32 <= LB (reference)": lambda la, lb: "search" if 32 * la <= lb else "stream",
    }
    for name, choose in rules.items():
        worst, mean = loss(choose)
        print(f"    {name}: time lost against the faster regime, worst {worst:.4f}, "
              f"mean {mean:.4f} over {len(points)} points", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
