// Device code that setop_rows.cu and setop_merge.cu share: the tile's
// shape, cp.async staging (of a window, or of every s-th word of one), the
// warp's 32-probe searches, the lockstep membership searches (over a
// window, or over a staged sample of a window too wide to stage), the
// scan of a tile's 64 chunks of keep bits, and the acquire and release of
// the decoupled look-back's status words.
//
// A tile is 2048 positions: 8 warps of 32 lanes, 8 positions a lane, so
// 64 chunks of 32 positions, one 128-byte line a warp's load. A status
// word is 64 bits, the tile's state in bits 62-63 (0: nothing published
// yet), its counts in the rest, as each kernel packs them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 8;                 // chunks of 32 positions a warp takes
constexpr int kChunks = kWarps * kPer;  // 64 a tile
constexpr int kTile = 32 * kChunks;     // 2048 positions
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kWindowMax = 8 * 1024;    // words of a staged window (32 KB)
constexpr int kMinCtas = 4;             // CTAs an SM holds at once (64 registers a thread)
// states of a tile's status word: its aggregate alone, or its inclusive prefix
constexpr unsigned long long kAgg = 1, kPrefix = 3;

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// n words from global memory to shared dst by every thread of the CTA,
// with cp.async: dst[i] = src[i * stride], all loads in flight at once;
// each thread waits for its own copies (the caller syncs).
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src, int n,
                                            int stride = 1) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + i);
    const uint32_t* from = src + (long long)i * stride;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(from) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The first i in [lo, hi) with pred(i), hi if none; pred false, then
// true, as i grows. The whole warp searches, 32 probes a round, so about
// log32(hi - lo) dependent rounds of loads. Every lane must call it with
// the same arguments.
template <typename Pred>
__device__ int warp_first(Pred pred, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {  // the answer lies in [lo, hi]
    const int step = (hi - lo + 31) / 32;
    const int at = lo + lane * step;
    // probes past hi count as past the answer
    const unsigned ball = __ballot_sync(kFull, at < hi ? pred(at) : true);
    if (ball == 0) {  // every probe before the answer
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(ball) - 1;
    if (f == 0) break;  // pred(lo) already: lo
    const int nhi = min(lo + f * step, hi);
    lo += (f - 1) * step + 1;
    hi = nhi;
  }
  return lo;
}

// The first i in [0, n) with key(i) > q (upper) or key(i) >= q (lower),
// n if none, key(i) of type T ascending in i, by warp_first.
template <typename T, typename Key>
__device__ int warp_search(Key key, int n, T q, bool upper) {
  return warp_first([&](int i) {
    const T v = key(i);
    return upper ? v > q : v >= q;
  }, 0, n);
}

// Is q[k] in b[at[k], at[k] + n[k])? For the kPer words of a lane at
// once (n[k] 0: not searched), b sorted ascending as uint32, in shared
// memory or in global memory through the read-only path; a branchless
// binary search for the last element <= q[k]. The searches run in
// lockstep, so that their kPer chains of dependent loads overlap. Returns
// bit k set where q[k] is found.
template <bool kInGlobal>
__device__ __forceinline__ unsigned member_all(const uint32_t* __restrict__ b,
                                               const int (&at)[kPer], int (&n)[kPer],
                                               const uint32_t (&q)[kPer]) {
  int base[kPer];
  unsigned empty = 0;  // words with nothing to search: searched at b[0], never hit
  int steps = 0;       // ceil(log2(n)) halvings take n to 1
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    base[k] = n[k] > 0 ? at[k] : 0;
    empty |= n[k] > 0 ? 0u : 1u << k;
    n[k] = max(n[k], 1);
    steps = max(steps, 32 - __clz(n[k] - 1));
  }
  for (int i = 0; i < steps; ++i) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // no branch: a word at n 1 keeps its place
      const int half = n[k] >> 1;
      const uint32_t x = kInGlobal ? __ldg(b + base[k] + half) : b[base[k] + half];
      base[k] += x <= q[k] ? half : 0;
      n[k] -= half;
    }
  }
  unsigned hits = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if ((kInGlobal ? __ldg(b + base[k]) : b[base[k]]) == q[k]) hits |= 1u << k;
  }
  return hits & ~empty;
}

// Is q[k] in W[0, wn), a sorted window in global memory too wide to stage
// (wn > kWindowMax)? S is its sample in shared memory, S[j] = W[j * s] for
// j < ns = ceil(wn / s). For the kPer words of a lane at once (those
// outside `live` not searched), in lockstep: the last S[j] <= q[k] in
// shared memory (ceil(log2 ns) steps); a word below S[0] is absent, one
// equal to S[j] found; else the last word <= q[k] in the bracket W[j * s,
// min((j + 1) * s, wn)) in global memory (ceil(log2 s) steps: with s <=
// 32, one or two 128-byte lines), a probe at wn or past it counting as
// above q[k]. The bracket holds the last word <= q[k] of the whole window,
// since W[(j + 1) * s] = S[j + 1] > q[k], so equal words across a bracket
// edge are found too. Returns bit k set where q[k] is found.
__device__ __forceinline__ unsigned member_sampled(const uint32_t* __restrict__ S, int ns,
                                                   const uint32_t* __restrict__ W, int wn, int s,
                                                   unsigned live, const uint32_t (&q)[kPer]) {
  int base[kPer];
  uint32_t val[kPer];  // the word at base[k]: S[base[k]], then W[base[k]]
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    base[k] = 0;
    val[k] = S[0];
  }
  for (int n = ns; n > 1;) {  // the answer lies in [base, base + n)
    const int half = n >> 1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t x = S[base[k] + half];
      if (x <= q[k]) base[k] += half, val[k] = x;
    }
    n -= half;
  }
  unsigned hits = 0, open = 0;  // found at a sample; left to the bracket
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    hits |= val[k] == q[k] ? 1u << k : 0u;
    open |= val[k] < q[k] ? 1u << k : 0u;
    base[k] *= s;
  }
  hits &= live;
  open &= live;
  for (int n = s; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (((open >> k) & 1u) && half < wn - base[k]) {  // base[k] + half < wn
        const uint32_t x = __ldg(W + base[k] + half);
        if (x <= q[k]) base[k] += half, val[k] = x;
      }
    }
    n -= half;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) hits |= ((open >> k) & 1u) && val[k] == q[k] ? 1u << k : 0u;
  return hits;
}

// Warp 0 alone: from the tile's keep bits (one word a chunk, in shared
// memory), chunk_off[c] = the kept words before chunk c and
// chunk_off[kChunks] = the tile's total, visible to the whole warp on
// return; every lane returns the total.
__device__ __forceinline__ int chunk_scan(const uint32_t* bits, int* chunk_off) {
  const int lane = threadIdx.x & 31;
  const int x0 = __popc(bits[lane]), x1 = __popc(bits[lane + 32]);
  int i0 = x0, i1 = x1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y0 = __shfl_up_sync(kFull, i0, d), y1 = __shfl_up_sync(kFull, i1, d);
    if (lane >= d) {
      i0 += y0;
      i1 += y1;
    }
  }
  const int half = __shfl_sync(kFull, i0, 31);
  const int total = half + __shfl_sync(kFull, i1, 31);
  chunk_off[lane] = i0 - x0;
  chunk_off[lane + 32] = half + i1 - x1;
  if (lane == 0) chunk_off[kChunks] = total;
  __syncwarp();
  return total;
}

}  // namespace
