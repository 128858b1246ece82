// setop_rows (K2 + K3) for Hopper: intersect and difference of sorted
// rows, membership and stable compaction fused.
//
// Replaces, in the JAX package, the XLA programs of
// dgraph_tpu/ops/setops.py: _searchsorted (:50) and membership (:61), K2,
// and compact (:73) with its fusions intersect (:87) and difference (:96),
// K3, as dgraph_tpu/query/dispatch.py runs them: vmapped over pow2 buckets
// of (A, LA, B, LB) pairs (_get_jitted :887, _run_bucket :911), or against
// one shared b (_get_jitted_shared :781, in_axes=(0, 0, None, None)).
//
// What it computes. For each row i of A (n, pa),
//   keep[i, j] = j < LA[i] and     A[i, j] in b_i[:lb_i]     (intersect)
//   keep[i, j] = j < LA[i] and not A[i, j] in b_i[:lb_i]     (difference)
// with b_i = B + i * b_stride (b_stride 0: one b shared by every row) and
// lb_i = LB[i * lb_step]; then out[i, :cnt[i]] holds the kept A[i, j] in
// order, out[i, cnt[i]:] = 0xFFFFFFFF and cnt[i] counts them: the
// (out, cnt) contract of setops.intersect and setops.difference.
// compact_rows_launch takes keep as a given byte mask instead
// (setops.compact). Uids are the bits of int32, compared unsigned. Rows
// are sorted ascending within LA / LB (the reference's precondition).
// Validity is judged by index against the lengths, never by value, so
// 0xFFFFFFFF stays a legal uid and padding of any value is never read as
// an element.
//
// What bounds it. Bytes: A's valid elements read once, the n * pa output
// words written once, the lengths and counts, and of b only the sectors
// the searches touch (b is shared by a row's chunks or by every row, so
// after the first search most of its levels come from L2). The compares,
// about log2(lb) an element, cost less than the element's own bytes.
//
// Design. A (n, pa) is cut into warp chunks of 128 elements, lane l
// holding elements l + 32 k (k < 4) of its chunk, so that each of a
// chunk's four loads is one 128-byte line. A lane binary-searches each of
// its elements in b ("the last element <= q", one dependent load a level,
// branchless), and one ballot per 32 elements gives the chunk's keep bits;
// their popcounts give each kept element its place among the chunk's.
//   - A row of one chunk (pa <= 128: the member sweep's rows and most rows
//     of a bucketed level) is finished by its warp in one kernel
//     (setop_rows_fused): it writes the kept elements at their places,
//     pads the rest and writes cnt.
//   - A longer row (pa up to 2^20 and more: the NOT filter's one row
//     against one long b) spreads over many CTAs, which cannot see each
//     other, so it takes three kernels: setop_rows_flags writes each
//     chunk's ballots and count to scratch; setop_rows_scan gives each row
//     one warp, which adds its chunks' counts 32 at a time with shuffles
//     into each chunk's offset and the row's cnt; setop_rows_scatter
//     writes each chunk's kept elements at offset + place (A read again,
//     from L2 where the row fits there) and the pad of the chunk's own
//     places at or past cnt.
// Every output word is written exactly once, so nothing is zeroed first.
// No sort, cumsum or nonzero runs in it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // chunks (or rows) per CTA, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 4;             // elements per lane in a chunk
constexpr int kChunk = 32 * kPer;   // elements per warp chunk
constexpr uint32_t kFull = 0xFFFFFFFFu;

struct Rows {
  const uint32_t* A;
  const int32_t* LA;     // null with keep
  const uint32_t* B;
  const int32_t* LB;
  const uint8_t* keep;   // compact_rows: the given mask; else null
  int64_t b_stride;      // elements between rows of B; 0: one shared b
  int lb_step;           // 1: LB per row; 0: LB[0] for every row
  int n, pa, pb, chunks, op;  // op 0 intersect, 1 difference
};

// Is q in b[0, n)? b sorted ascending as uint32; n >= 0.
__device__ __forceinline__ bool member(const uint32_t* __restrict__ b, int n,
                                       uint32_t q) {
  if (n <= 0) return false;
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    if (__ldg(b + base + half) <= q) base += half;
    n -= half;
  }
  return __ldg(b + base) == q;
}

// The keep bits of chunk c of `row`: bit l of bits[k] is element
// c * kChunk + 32 k + l. Every lane of the warp must call it.
__device__ __forceinline__ void chunk_bits(const Rows& r, int64_t row, int c,
                                           int lane, uint32_t (&bits)[kPer]) {
  const int64_t base = row * r.pa;
  int la = r.pa, lb = 0;
  const uint32_t* brow = r.B;
  if (r.keep == nullptr) {
    la = min(max(r.LA[row], 0), r.pa);
    lb = min(max(r.LB[row * r.lb_step], 0), r.pb);
    brow = r.B + row * r.b_stride;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = c * kChunk + 32 * k + lane;
    bool kept = false;
    if (j < la) {
      if (r.keep != nullptr) {
        kept = r.keep[base + j] != 0;
      } else {
        const bool hit = member(brow, lb, __ldg(r.A + base + j));
        kept = r.op == 0 ? hit : !hit;
      }
    }
    bits[k] = __ballot_sync(kFull, kept);
  }
}

// Write chunk c's kept elements from place `off` of the row on.
__device__ __forceinline__ void scatter_chunk(const Rows& r, int64_t row, int c,
                                              int lane, const uint32_t (&bits)[kPer],
                                              int off, uint32_t* __restrict__ out) {
  const int64_t base = row * r.pa;
  const uint32_t below = (1u << lane) - 1u;  // lanes before this one
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = c * kChunk + 32 * k + lane;
    if ((bits[k] >> lane) & 1u) out[base + off + __popc(bits[k] & below)] = __ldg(r.A + base + j);
    off += __popc(bits[k]);
  }
}

// Pad chunk c's places at or past the row's count.
__device__ __forceinline__ void pad_chunk(const Rows& r, int64_t row, int c, int lane,
                                          int total, uint32_t* __restrict__ out) {
  const int64_t base = row * r.pa;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = c * kChunk + 32 * k + lane;
    if (j < r.pa && j >= total) out[base + j] = kFull;
  }
}

// Rows of one chunk: one warp a row does it all.
__global__ void __launch_bounds__(kThreads)
setop_rows_fused(Rows r, uint32_t* __restrict__ out, int32_t* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= r.n) return;  // whole warp
  uint32_t bits[kPer];
  chunk_bits(r, row, 0, lane, bits);
  scatter_chunk(r, row, 0, lane, bits, 0, out);
  int total = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) total += __popc(bits[k]);
  pad_chunk(r, row, 0, lane, total, out);
  if (lane == 0) cnt[row] = total;
}

// Longer rows, pass 1: each chunk's ballots and count.
__global__ void __launch_bounds__(kThreads)
setop_rows_flags(Rows r, uint32_t* __restrict__ bits_out, int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= (int64_t)r.n * r.chunks) return;  // whole warp
  const int64_t row = g / r.chunks;
  const int c = (int)(g - row * r.chunks);
  uint32_t bits[kPer];
  chunk_bits(r, row, c, lane, bits);
  if (lane < kPer) {
    uint32_t mine = bits[0];
#pragma unroll
    for (int k = 1; k < kPer; ++k)
      if (lane == k) mine = bits[k];
    bits_out[g * kPer + lane] = mine;
  }
  if (lane == 0) {
    int total = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) total += __popc(bits[k]);
    counts[g] = total;
  }
}

// Pass 2: one warp a row scans its chunks' counts into offsets and cnt.
__global__ void __launch_bounds__(kThreads)
setop_rows_scan(const int32_t* __restrict__ counts, int32_t* __restrict__ offsets,
                int32_t* __restrict__ cnt, int n, int chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp
  const int64_t base = row * chunks;
  int carry = 0;
  for (int s = 0; s < chunks; s += 32) {  // the same trip count in every lane
    const int i = s + lane;
    const int v = i < chunks ? counts[base + i] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (i < chunks) offsets[base + i] = carry + x - v;
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) cnt[row] = carry;
}

// Pass 3: each chunk writes its kept elements and its share of the pad.
__global__ void __launch_bounds__(kThreads)
setop_rows_scatter(Rows r, const uint32_t* __restrict__ bits_in,
                   const int32_t* __restrict__ offsets, const int32_t* __restrict__ cnt,
                   uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= (int64_t)r.n * r.chunks) return;
  const int64_t row = g / r.chunks;
  const int c = (int)(g - row * r.chunks);
  uint32_t bits[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) bits[k] = bits_in[g * kPer + k];
  scatter_chunk(r, row, c, lane, bits, offsets[g], out);
  pad_chunk(r, row, c, lane, cnt[row], out);
}

unsigned blocks_for(int64_t warps) { return (unsigned)((warps + kWarps - 1) / kWarps); }

int run(Rows r, int32_t* out32, int32_t* cnt, int32_t* scratch, cudaStream_t stream) {
  if (r.n <= 0 || r.pa <= 0) return 0;  // the wrapper writes cnt = 0
  uint32_t* out = reinterpret_cast<uint32_t*>(out32);
  r.chunks = (r.pa + kChunk - 1) / kChunk;
  if (r.chunks == 1) {
    setop_rows_fused<<<blocks_for(r.n), kThreads, 0, stream>>>(r, out, cnt);
    return (int)cudaGetLastError();
  }
  const int64_t g = (int64_t)r.n * r.chunks;
  uint32_t* bits = reinterpret_cast<uint32_t*>(scratch);
  int32_t* counts = scratch + g * kPer;
  int32_t* offsets = counts + g;
  setop_rows_flags<<<blocks_for(g), kThreads, 0, stream>>>(r, bits, counts);
  int err = (int)cudaGetLastError();
  if (err) return err;
  setop_rows_scan<<<blocks_for(r.n), kThreads, 0, stream>>>(counts, offsets, cnt, r.n, r.chunks);
  err = (int)cudaGetLastError();
  if (err) return err;
  setop_rows_scatter<<<blocks_for(g), kThreads, 0, stream>>>(r, bits, offsets, cnt, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 words of scratch a call over (n, pa) needs: 0 for rows of one
// chunk, else 4 ballots, a count and an offset a chunk.
int64_t setop_rows_scratch(int n, int pa) {
  const int64_t chunks = (pa + kChunk - 1) / kChunk;
  return chunks <= 1 ? 0 : (int64_t)n * chunks * (kPer + 2);
}

// out: (n, pa), cnt: (n,), scratch: setop_rows_scratch(n, pa) words; op 0
// intersect, 1 difference. B holds rows b_stride apart (0: one shared b of
// pb elements) and LB one length a row (lb_step 1) or one for all (0).
// Returns 0 or the cudaError_t of the first launch that failed.
int setop_rows_launch(const int32_t* A, const int32_t* LA, const int32_t* B,
                      const int32_t* LB, int32_t* out, int32_t* cnt, int32_t* scratch,
                      int n, int pa, int pb, int64_t b_stride, int lb_step, int op,
                      cudaStream_t stream) {
  if (op != 0 && op != 1) return (int)cudaErrorInvalidValue;
  Rows r{reinterpret_cast<const uint32_t*>(A), LA, reinterpret_cast<const uint32_t*>(B),
         LB, nullptr, b_stride, lb_step, n, pa, pb, 0, op};
  return run(r, out, cnt, scratch, stream);
}

// The stable compaction of A (n, pa) where keep (n, pa bytes) is set.
int compact_rows_launch(const int32_t* A, const uint8_t* keep, int32_t* out, int32_t* cnt,
                        int32_t* scratch, int n, int pa, cudaStream_t stream) {
  Rows r{reinterpret_cast<const uint32_t*>(A), nullptr, nullptr, nullptr, keep, 0, 0,
         n, pa, 0, 0, 0};
  return run(r, out, cnt, scratch, stream);
}

}  // extern "C"
