// Member sweep (K1) for Hopper: per-row search or stream over sorted rows.
//
// Replaces dgraph_tpu/ops/pallas_setops.py::_member_kernel (the one Pallas
// kernel of the JAX package, launched through _membership_padded). The
// TPU kernel compared every query with every element of B, because the
// TPU gathers slowly; Hopper gathers well, and the rows are sorted, so
// this kernel searches instead.
//
// What it computes. For each row i of a bucket,
//   hit[i, t] = t < LA[i]  and  A[i, t] occurs in b_i[:lb_i]
// with A (n, pa <= 128) and b_i = B + i * b_stride, lb_i = LB[i * lb_step],
// holding uids in the 32-bit local space as the bits of int32: B (n, pb)
// with LB (n,) (b_stride pb, lb_step 1), or one b (pb,) shared by every
// row with one length (b_stride 0, lb_step 0: the reference's
// vmap(in_axes=(0, 0, None, None)) form). Precondition (the reference's,
// pallas_setops.py:109-111): A[i, :LA[i]] and B[i, :LB[i]] are sorted
// ascending as uint32; A may hold equal values, and every one of them is
// marked. All compares are unsigned. Validity is judged by index against
// LA / LB, never by value: 0xFFFFFFFF stays a legal uid, and padding of
// any value (zeros or 0xFFFFFFFF) never creates a hit.
//
// What bounds it. On sorted rows a correct method needs A's valid bytes,
// the lengths, the mask, and in B only the 32-byte sectors that hold each
// query's equal element or, where there is none, its two neighbours: a few
// sectors per query, against 3.35 TB/s of HBM. The compares, about
// LA * log2(LB / LA + 1) per row, take less time than those bytes. What
// limits a real kernel is different in the two shapes of row:
//   - few queries against a long row: the chain of dependent loads of a
//     binary search (one round trip to memory per level, ~log2(LB) levels);
//   - many queries against a short row: the bytes of B, since the queries
//     together touch most of its sectors anyway.
//
// What the design does about that. One warp owns one row (4 rows per CTA,
// no span grid, no memset) and writes all pa bytes of its mask, zeros
// included. Lane l holds queries t = l + 32k (k < ceil(LA / 32) <= 4) in
// registers; the number of slots in use is a template parameter, so the
// loops over them unroll without predicates and their loads issue
// together. Per row the warp picks one of two regimes. The reference's
// rule for search against merge is LA * 32 <= LB (dgraph_tpu/ops/
// setops.py:56); on the H100 streaming stays faster further out, so a row
// is searched from LB >= max(64 LA, 768) on (search_from(); the crossover
// measured by member_sweep_crossover.py is in PERF.md). A search costs
// its chain of levels whatever the number of queries, a stream costs the
// row's bytes, so short rows of few queries stream:
//   - search (LB >= search_from(LA)): a branchless binary search per
//     query in device memory, "the last element <= q", one dependent load
//     per level and a hit iff that element equals q. A lane's queries run
//     interleaved, so each level has up to four loads in flight per lane;
//     lanes hold neighbouring queries of a sorted A, so the upper levels
//     are the same addresses across the warp (one transaction, then L1).
//     To shorten the chain, a long row first has up to 1024 splitters
//     (B[j * step]: 2 per query and at least 32, never closer than 16
//     elements) copied into shared memory all at once: one round trip
//     instead of log2(splitters) dependent ones, and the coarse levels of
//     every search then run in shared memory. Two per query, not more:
//     each splitter is a sector of its own, and more of them would cost
//     more bytes than the levels they save.
//   - stream (otherwise, so LB < max(64 LA, 768) <= 8192: at most 32 KB
//     of B): the warp copies B's valid window into shared memory 1024
//     elements at a time with cp.async (16 bytes a lane, all of a tile in
//     flight at once, no registers held; not TMA, since a warp owns its
//     row and its tile and needs no barrier shared with other warps).
//     Each lane then
//     binary-searches its queries that fall within the tile's range in
//     shared memory, so a row costs LA * log2(1024) shared loads rather
//     than LB searches in A. Reading stops at the first tile whose last
//     element reaches A[LA - 1].
// Unaligned rows (pb not a multiple of 4) copy the head and tail of each
// tile 4 bytes at a time, keeping the shared copy's alignment equal to
// the row's so the 16-byte middle needs no shuffling.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;           // rows per CTA, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 8;       // CTAs per SM the registers must allow
constexpr int kSlots = 4;           // queries per lane: pa <= 128
constexpr int kTile = 1024;         // stream: B elements staged per step
constexpr int kBuf = kTile + 4;     // + room to keep the row's alignment
constexpr int kMaxSplit = 1024;     // search: splitters staged per row
constexpr int kSplitPerQuery = 2;
constexpr int kMinSplitGap = 16;    // B elements between splitters, at least
constexpr int kSearchRatio = 64;    // search from LB >= 64 LA ...
constexpr int kSearchMinLB = 768;   // ... and LB >= 768 on
static_assert(kMaxSplit <= kBuf, "splitters share the stream tile's buffer");

// The regime rule: a row of la queries is searched from this LB on and
// streamed below it. The kernel and member_sweep_search_from() share it.
__host__ __device__ __forceinline__ int64_t search_from(int la) {
  const int64_t r = (int64_t)la * kSearchRatio;
  return r > kSearchMinLB ? r : kSearchMinLB;
}

// ceil(log2(n)) for n >= 1: the levels of a search over n elements
__device__ __forceinline__ int levels(int n) {
  return n <= 1 ? 0 : 32 - __clz(n - 1);
}

// Asynchronous copies from device into shared memory; cp_wait_warp()
// waits for this lane's, then makes every lane's visible to the warp.
__device__ __forceinline__ void cp16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_wait_warp() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Index of the last element <= q in s[0, n), or 0 when there is none.
// n >= 1. Shared memory.
__device__ __forceinline__ int floor_in(const uint32_t* s, int n, uint32_t q) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    if (s[base + half] <= q) base += half;
    n -= half;
  }
  return base;
}

// NQ: query slots in use (ceil(LA / 32)), so every loop over them unrolls
// without a predicate and their loads issue together.
template <int NQ>
__device__ void search_row(const uint32_t* __restrict__ brow, int la, int lb,
                           uint32_t* split, int lane,
                           const uint32_t (&q)[kSlots], bool (&hit)[kSlots]) {
  // splitters: kSplitPerQuery per query (at least one per lane), none
  // closer than kMinSplitGap elements, so the staged sectors cost about
  // what the searches they shorten would have read
  int k_split = min(kMaxSplit, max(32, la * kSplitPerQuery));
  while (k_split >= 32 && lb < k_split * kMinSplitGap) k_split >>= 1;
  int base[NQ], n[NQ], step = lb;
  uint32_t cur[NQ];  // B[base]: the last element <= q found so far
  if (k_split >= 32) {
    step = (lb + k_split - 1) / k_split;
    const int n_split = (lb + step - 1) / step;
    for (int j = lane; j < n_split; j += 32)
      cp4(split + j, brow + (int64_t)j * step);
    cp_wait_warp();
#pragma unroll
    for (int k = 0; k < NQ; ++k) base[k] = 0;
    for (int m = n_split; m > 1;) {  // the coarse levels, in shared memory
      const int half = m >> 1;
#pragma unroll
      for (int k = 0; k < NQ; ++k)
        if (split[base[k] + half] <= q[k]) base[k] += half;
      m -= half;
    }
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      cur[k] = split[base[k]];
      base[k] *= step;
      n[k] = min(step, lb - base[k]);
    }
  } else {
    const uint32_t b0 = __ldg(brow);
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      base[k] = 0;
      n[k] = lb;
      cur[k] = b0;
    }
  }
  // the fine levels in device memory, one load per query per level; a
  // window already down to one element reloads it, which changes nothing
  const int iters = levels(step);
  for (int s = 0; s < iters; ++s) {
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int half = n[k] >> 1;
      const uint32_t v = __ldg(brow + base[k] + half);
      if (v <= q[k]) {
        base[k] += half;
        cur[k] = v;
      }
      n[k] -= half;
    }
  }
#pragma unroll
  for (int k = 0; k < NQ; ++k) hit[k] = cur[k] == q[k];
}

template <int NQ>
__device__ void stream_row(const uint32_t* __restrict__ brow, int lb,
                           uint32_t* buf, int lane, uint32_t amax,
                           const uint32_t (&q)[kSlots], bool (&hit)[kSlots]) {
  for (int start = 0; start < lb; start += kTile) {
    const int cnt = min(kTile, lb - start);
    const uint32_t* src = brow + start;
    // dst[j] = src[j], with dst and src equal modulo 16 bytes
    const int off = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    uint32_t* dst = buf + off;
    const int head = min(cnt, (4 - off) & 3);
    const int n4 = (cnt - head) >> 2;
    const int tail = head + (n4 << 2);
    for (int g = lane; g < n4; g += 32)
      cp16(dst + head + 4 * g, src + head + 4 * g);
    if (lane < head) cp4(dst + lane, src + lane);
    if (tail + lane < cnt) cp4(dst + tail + lane, src + tail + lane);
    cp_wait_warp();

    const uint32_t first = dst[0], last = dst[cnt - 1];
#pragma unroll
    for (int k = 0; k < NQ; ++k)
      if (!hit[k] && q[k] >= first && q[k] <= last)
        hit[k] = dst[floor_in(dst, cnt, q[k])] == q[k];
    __syncwarp();  // the tile is read by all lanes before the next overwrites it
    if (last >= amax) break;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
member_sweep_kernel(const uint32_t* __restrict__ A,
                    const int32_t* __restrict__ LA,
                    const uint32_t* __restrict__ B,
                    const int32_t* __restrict__ LB,
                    uint8_t* __restrict__ hits,
                    int n, int pa, int pb, int64_t b_stride, int lb_step) {
  __shared__ __align__(16) uint32_t smem[kWarps][kBuf];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= n) return;  // whole warp; no CTA-wide barrier follows
  const int la = min(max(LA[row], 0), pa);
  const int lb = min(max(LB[row * lb_step], 0), pb);
  const uint32_t* arow = A + row * pa;
  const uint32_t* brow = B + row * b_stride;

  uint32_t q[kSlots];
  bool hit[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int t = lane + 32 * k;
    q[k] = t < la ? __ldg(arow + t) : 0u;
    hit[k] = false;
  }
  if (la > 0 && lb > 0) {
    uint32_t* buf = smem[warp];
    const int nq = (la + 31) >> 5;  // the same in every lane
    if (lb >= search_from(la)) {
      switch (nq) {
        case 1: search_row<1>(brow, la, lb, buf, lane, q, hit); break;
        case 2: search_row<2>(brow, la, lb, buf, lane, q, hit); break;
        case 3: search_row<3>(brow, la, lb, buf, lane, q, hit); break;
        default: search_row<4>(brow, la, lb, buf, lane, q, hit); break;
      }
    } else {
      const uint32_t amax = __ldg(arow + la - 1);
      switch (nq) {
        case 1: stream_row<1>(brow, lb, buf, lane, amax, q, hit); break;
        case 2: stream_row<2>(brow, lb, buf, lane, amax, q, hit); break;
        case 3: stream_row<3>(brow, lb, buf, lane, amax, q, hit); break;
        default: stream_row<4>(brow, lb, buf, lane, amax, q, hit); break;
      }
    }
  }
  uint8_t* out = hits + row * pa;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int t = lane + 32 * k;
    if (t < pa) out[t] = (t < la && hit[k]) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// hits: (n, pa) bytes, every one written by the kernel; pa <= 128. Row i
// of B starts b_stride elements after row i - 1 (0: one shared b of pb
// elements) and its length is LB[i * lb_step].
// Returns 0 or the cudaError_t of the launch.
int member_sweep_launch(const int32_t* A, const int32_t* LA, const int32_t* B,
                        const int32_t* LB, uint8_t* hits, int n, int pa,
                        int pb, int64_t b_stride, int lb_step,
                        cudaStream_t stream) {
  if (pa > 32 * kSlots) return (int)cudaErrorInvalidValue;
  if (n == 0 || pa == 0) return 0;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  member_sweep_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(A), LA,
      reinterpret_cast<const uint32_t*>(B), LB, hits, n, pa, pb, b_stride,
      lb_step);
  return (int)cudaGetLastError();
}

// The least LB at which a row of la valid queries is searched.
int64_t member_sweep_search_from(int la) { return search_from(la); }

}  // extern "C"
