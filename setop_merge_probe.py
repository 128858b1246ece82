#!/usr/bin/env python3
"""Where a tile's time goes in setop_merge's kernels (K4, K5, K6).

    python3 setop_merge_probe.py

Builds a probe copy of `dgraph_tpu_torch/csrc/setop_merge.cu` into the
port's build directory: thread 0 of each tile stamps `clock64()` at the
end of each phase and `%globaltimer` at the tile's start and end, into a
`__device__` array read back with `cudaMemcpyFromSymbol`. A union tile's
phases (`union_tile`, K4 and every round of K5): the boundary searches,
the staging, the merge and block scan, the look-back, the write-out. An
intersect tile's (K6): the window bounds and the staging of windows or
their samples (each summed over the lists the tile searched), then the
rest of the tile until its places are known (its words' loads, the
searches, the scan), the look-back, the write-out. Then it runs the
wrappers on phase 3c's lists (`chip_smoke.merge_lists_case`) and prints,
for each shape, each phase's median, 90th percentile and largest time
over the tiles (SM cycles over the card's largest SM clock), for K6 the
lists a tile searched, and, for each round of a k-way merge, its tiles
and its span on the card's clock. The stamps cost time of their own:
read the phases against each other, and the kernel's time from phase 3c.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

SLOTS = 1 << 15  # tiles a run can stamp
PHASES = ("boundary searches", "staging", "merge + scan", "look-back", "write out")
MANY_PHASES = ("window bounds", "stage or sample", "search", "the rest, scan", "look-back",
               "write out")
SHAPES = [("merge_sorted", "64 lists of 1,000", [1000] * 64, "random"),
          ("merge_sorted", "256 lists of 1,000", [1000] * 256, "random"),
          ("merge_sorted", "3 x 10^5", [100000] * 3, "random"),
          ("union_ragged", "10,000 pairs of 64 and 1,024", [64, 1024] * 10000, "random"),
          ("union_ragged", "(e): 2 pairs of 1,000 and 99,000", [1000, 99000] * 2, "random"),
          ("intersect_many", "(c): 2,000 within 200,000", [2000, 200000], "all"),
          ("intersect_many", "3 x 10^5", [100000] * 3, "random"),
          ("intersect_many", "2,000 within 2^20", [2000, 1 << 20], "all")]

# (text in the source, what replaces it): the stamps
EDITS = [
    ('#include "setop_common.cuh"\n', '''#include "setop_common.cuh"
__device__ long long g_probe[%d][12];  // round, tile, clock64 at 6 marks (K6: 7), start and end ns
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
    # K6: marks 2-8; the bounds (with the tile's loads), staging and searches
    # summed over the lists; [11] the lists searched
    ("    const int e = min(s + kTile, P);\n",
     """    const int e = min(s + kTile, P);
    const int slot = threadIdx.x == 0 ? atomicAdd(&g_slot, 1) : %d;
    long long c0 = clock64(), c_bounds = 0, c_stage = 0, c_search = 0, c_lists = 0;
    if (slot < %d) g_probe[slot][0] = 0, g_probe[slot][1] = t, g_probe[slot][9] = probe_ns();
    if (slot < %d) g_probe[slot][2] = c0;
""" % (SLOTS, SLOTS, SLOTS)),
    ("      if (warp < 2 * nl) {\n", "      if (l0 > 1) c0 = clock64();\n      if (warp < 2 * nl) {\n"),
    ("      __syncthreads();  // the round's windows\n",
     "      __syncthreads();  // the round's windows\n      c_bounds += clock64() - c0;\n"),
    ("        stage_words(sw, W, ns, stride);\n",
     "        const long long c1 = clock64();\n        ++c_lists;\n        stage_words(sw, W, ns, stride);\n"),
    ("        __syncthreads();  // the window or its sample staged\n",
     "        __syncthreads();  // the window or its sample staged\n"
     "        const long long c2 = clock64();\n        c_stage += c2 - c1;\n"),
    ("        left = __syncthreads_or(alive != 0);\n",
     "        left = __syncthreads_or(alive != 0);\n        c_search += clock64() - c2;\n"),
    ("    const int total = chunk_off[kChunks];\n",
     """    if (threadIdx.x == 0 && slot < %d) {
      g_probe[slot][3] = g_probe[slot][2] + c_bounds;
      g_probe[slot][4] = g_probe[slot][3] + c_stage;
      g_probe[slot][5] = g_probe[slot][4] + c_search;
      g_probe[slot][6] = clock64();
      g_probe[slot][11] = c_lists;
    }
    const int total = chunk_off[kChunks];
""" % SLOTS),
    ("    const int gex = look_back_block(a.status, t, total, s_first, s_sums);\n",
     "    const int gex = look_back_block(a.status, t, total, s_first, s_sums);\n    PROBE(7)\n"),
    ("    __syncthreads();  // before the next tile reuses the shared state\n  }\n}",
     "    __syncthreads();  // before the next tile reuses the shared state\n    PROBE(8)\n"
     "    if (threadIdx.x == 0 && slot < %d) g_probe[slot][10] = probe_ns();\n  }\n}" % SLOTS),
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
    for name, label, lens, kind in SHAPES:
        args = [torch.from_numpy(x).cuda()
                for x in chip_smoke.merge_lists_case(lens, seed=len(lens), kind=kind)]
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
        many = name == "intersect_many"
        end = 8 if many else 7  # the column of the last mark
        us = np.diff(got[:, 2 : end + 1], axis=1) / mhz
        if many:
            print(f"  lists searched a tile: mean {got[:, 11].mean():.2f}, max {got[:, 11].max()}")
        for i, phase in enumerate(MANY_PHASES if many else PHASES):
            print(f"  {phase:18s} median {np.median(us[:, i]):7.3f} us, p90 "
                  f"{np.percentile(us[:, i], 90):7.3f}, max {us[:, i].max():7.3f}")
        total = (got[:, end] - got[:, 2]) / mhz
        print(f"  {'tile':18s} median {np.median(total):7.3f} us, max {total.max():7.3f}")
        t0 = got[:, 9].min()
        for r in np.unique(got[:, 0]):
            rr = got[got[:, 0] == r]
            print(f"  round {r}: {len(rr)} tiles, started {(rr[:, 9].min() - t0) / 1e3:.3f}-"
                  f"{(rr[:, 9].max() - t0) / 1e3:.3f} us, the last ended {(rr[:, 10].max() - t0) / 1e3:.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
