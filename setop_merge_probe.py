#!/usr/bin/env python3
"""Where a union tile's time goes in setop_merge's K4 and K5 kernels.

    python3 setop_merge_probe.py

Builds a probe copy of `dgraph_tpu_torch/csrc/setop_merge.cu` into the
port's build directory: thread 0 of each tile stamps `clock64()` at the
end of each phase of `union_tile` (the boundary searches, the staging,
the merge and block scan, the look-back, the write-out) and
`%globaltimer` at the tile's start and end, into a `__device__` array
read back with `cudaMemcpyFromSymbol`. Then it runs `union_ragged` and
`merge_sorted` on phase 3c's lists (`chip_smoke.merge_lists_case`, kind
random) and prints, for each shape, each phase's median, 90th percentile
and largest time over the tiles (SM cycles over the card's largest SM
clock) and, for each round of a k-way merge, its tiles and its span on
the card's clock. The stamps cost time of their own: read the phases
against each other, and the kernel's time from phase 3c. Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

SLOTS = 1 << 15  # tiles a run can stamp
PHASES = ("boundary searches", "staging", "merge + scan", "look-back", "write out")
SHAPES = [("merge_sorted", "64 lists of 1,000", [1000] * 64),
          ("merge_sorted", "256 lists of 1,000", [1000] * 256),
          ("merge_sorted", "3 x 10^5", [100000] * 3),
          ("union_ragged", "10,000 pairs of 64 and 1,024", [64, 1024] * 10000),
          ("union_ragged", "(e): 2 pairs of 1,000 and 99,000", [1000, 99000] * 2)]

# (text in the source, what replaces it): the stamps
EDITS = [
    ('#include "setop_common.cuh"\n', '''#include "setop_common.cuh"
__device__ long long g_probe[%d][12];  // round, tile, clock64 at 6 marks, -, start and end ns
__device__ int g_slot;
__device__ __forceinline__ long long probe_ns() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE(n) if (threadIdx.x == 0 && slot < %d) g_probe[slot][n] = clock64();
''' % (SLOTS, SLOTS)),
    ("""__device__ __forceinline__ void union_tile(const UnionArgs& a, UnionShared& sm, int t, int P,
                                           int tiles) {""",
     """__device__ __forceinline__ void union_tile(const UnionArgs& a, UnionShared& sm, int t, int P,
                                           int tiles, int r) {
  __shared__ int s_slot;
  if (threadIdx.x == 0) {
    s_slot = atomicAdd(&g_slot, 1);
    if (s_slot < %d) {
      g_probe[s_slot][0] = r, g_probe[s_slot][1] = t, g_probe[s_slot][9] = probe_ns();
      g_probe[s_slot][2] = clock64();
    }
  }
  __syncthreads();
  const int slot = s_slot;""" % SLOTS),
    ("  __syncthreads();\n  const int j0 = sm.j0,", "  __syncthreads();\n  PROBE(3)\n  const int j0 = sm.j0,"),
    ("  __syncthreads();\n  auto lo_at", "  __syncthreads();\n  PROBE(4)\n  auto lo_at"),
    ("  __syncthreads();  // every thread's merge has read the staged words",
     "  __syncthreads();  // every thread's merge has read the staged words\n  PROBE(5)"),
    ("sm.first, sm.sums);\n  __syncthreads();\n", "sm.first, sm.sums);\n  __syncthreads();\n  PROBE(6)\n"),
    ("  __syncthreads();  // before the next tile reuses the shared state\n}",
     "  __syncthreads();  // before the next tile reuses the shared state\n  PROBE(7)\n"
     "  if (threadIdx.x == 0 && slot < %d) g_probe[slot][10] = probe_ns();\n}" % SLOTS),
    ("union_tile(a, sm, t, P, tiles);\n  }\n}", "union_tile(a, sm, t, P, tiles, 0);\n  }\n}"),
    ("union_tile(a, sm, t, P, tiles);\n    if (r + 1", "union_tile(a, sm, t, P, tiles, r);\n    if (r + 1"),
]
READER = '''
extern "C" int probe_read(long long* dst, int* n) {
  int err = (int)cudaMemcpyFromSymbol(n, g_slot, sizeof(int));
  if (!err) err = (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(long long) * 12 * %d);
  return err;
}
extern "C" int probe_reset() {
  int z = 0;
  return (int)cudaMemcpyToSymbol(g_slot, &z, sizeof(int));
}
''' % SLOTS


def probe_source(src: str) -> str:
    """setop_merge.cu's text with the stamps in; raises if the kernel no
    longer has the text a stamp goes after."""
    for old, new in EDITS:
        if src.count(old) != 1:
            raise ValueError(f"setop_merge.cu changed: {old[:60]!r} is not there once")
        src = src.replace(old, new)
    return src + READER


def build():
    """The probe copy, built by nvcc into the port's build directory and
    bound as setop_merge's library."""
    from dgraph_tpu_torch.ops import cuda_build, setop_merge

    out = os.path.join(cuda_build.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "setop_merge_probe.cu"), os.path.join(out, "setop_merge_probe.so")
    with open(os.path.join(cuda_build.CSRC, "setop_merge.cu")) as f:
        text = probe_source(f.read())
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = setop_merge.bind(ctypes.CDLL(so))
    for fn in (lib.probe_read, lib.probe_reset):
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    import chip_smoke
    from dgraph_tpu_torch.ops import setop_merge

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.check_output(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], text=True).strip()
    mhz = float(subprocess.check_output(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                         "--format=csv,noheader,nounits"], text=True).split()[0])
    print(f"{card}; SM cycles read at {mhz:.0f} MHz")
    lib = setop_merge._lib = build()
    stamps = np.zeros((SLOTS, 12), np.int64)
    count = ctypes.c_int(0)
    for name, label, lens in SHAPES:
        args = [torch.from_numpy(x).cuda() for x in chip_smoke.merge_lists_case(lens, seed=len(lens))]
        fn = getattr(setop_merge, name)
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        if lib.probe_reset():
            raise RuntimeError("probe_reset failed")
        fn(*args)
        torch.cuda.synchronize()
        if lib.probe_read(stamps.ctypes.data_as(ctypes.c_void_p), ctypes.byref(count)):
            raise RuntimeError("probe_read failed")
        got = stamps[: min(count.value, SLOTS)]
        print(f"{name} {label}: {len(got)} tiles")
        us = np.diff(got[:, 2:8], axis=1) / mhz
        for i, phase in enumerate(PHASES):
            print(f"  {phase:18s} median {np.median(us[:, i]):7.3f} us, p90 "
                  f"{np.percentile(us[:, i], 90):7.3f}, max {us[:, i].max():7.3f}")
        total = (got[:, 7] - got[:, 2]) / mhz
        print(f"  {'tile':18s} median {np.median(total):7.3f} us, max {total.max():7.3f}")
        t0 = got[:, 9].min()
        for r in np.unique(got[:, 0]):
            rr = got[got[:, 0] == r]
            print(f"  round {r}: {len(rr)} tiles, started {(rr[:, 9].min() - t0) / 1e3:.3f}-"
                  f"{(rr[:, 9].max() - t0) / 1e3:.3f} us, the last ended {(rr[:, 10].max() - t0) / 1e3:.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
