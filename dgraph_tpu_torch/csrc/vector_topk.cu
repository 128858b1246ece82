// KV1 for Hopper: the vector distance epilogue, the mask and a per-row top-k.
//
// Replaces the device program of dgraph_tpu/models/vector.py:178
// _jit_brute and :194 _jit_brute_batch (with :1689 _distances and :1705
// _distances_batch), and the two lax.top_k steps of :232 _ivf_probe:
// after the GEMM dot = Q @ V^T (left to torch.matmul, as the reference
// left it to XLA), each query row is turned into distances, masked, and
// its k smallest are written in ascending order with their columns.
//
// What it computes. For row i of x (rows, ldx) and column j < n, with
// c = col_index ? col_index[j] : j:
//   euclidean (0)  d = (sqnorm[c] - 2 x[i, c]) + qstat[i]        qstat = |q|^2
//   cosine    (1)  d = 1 - x[i, c] / max(sqrt(sqnorm[c]) qstat[i], 1e-12)
//                                                                qstat = |q|
//   dotproduct(2)  d = -x[i, c]
//   distance  (3)  d = x[i, c]                         (ready distances)
// then d = +inf where valid[c] == 0, and the k smallest d of the row are
// written ascending, ties to the lower column: the order of
// lax.top_k(-d, k), which is the IEEE total order on d (-0.0 before 0.0,
// NaN after +inf), then the column. Every op of the epilogue is written
// with an _rn intrinsic, so nvcc contracts nothing into an FMA and the
// distances equal the plain PyTorch version's bit for bit.
//
// Order. Each element becomes a 64-bit key, (orderable(d) << 32) | j,
// where orderable() maps the float's bits to a uint32 that sorts in the
// total order. Keys are unique, so "the k smallest keys" is exactly the
// reference's answer, ties and all, and neither regime below needs a
// stable algorithm.
//
// What bounds it. The function reads each element of the row once (4
// bytes, plus the L2-resident sqnorm and valid per column) and writes
// 8 k bytes: memory-bound, at 3.35 TB/s. At the batched brute search (64
// queries over a 2^20-row corpus) that is 268 MB of dot, about 0.08 ms.
//
// What the design does about that. Two regimes, switched on k in this
// file alone (vector_topk_select_max_k()). The select regime was faster
// than the sort at every k measured on the card (PERF.md), so it takes
// every k its finish step can hold in shared memory: the k keys, 4096
// keys of the boundary bin and a histogram, 176 KB.
//   - select (k <= 16384), three launches. A row is cut into chunks so
//     that the grid holds about two CTAs per SM whatever the number of
//     rows (one CTA per row left half the card idle at 64 rows and ran
//     one row on one SM), and each thread keeps 16 loads in flight, as
//     float4 where the row allows (one 4-byte load a thread ran at about
//     6 GB/s per SM, latency-bound).
//       1. hist: each CTA builds a 4096-bin histogram of its chunk's keys'
//          top 12 bits in shared memory (warp-aggregated atomics:
//          distances crowd into a few bins) and adds it to the row's
//          histogram in global memory.
//       2. collect: each CTA finds, by a block scan of the row's
//          histogram, the bin that holds the k-th key, then reads its
//          chunk again and appends the keys of lower bins (fewer than k
//          in the row) and of that bin to two lists in global scratch.
//       3. finish, one CTA per row: where the bin's list holds more than
//          4096 keys, further 12-bit histograms over the list alone
//          narrow it until it fits; the keys still needed are sorted in
//          shared memory (bitonic), join the lower bins' keys, and those
//          k are sorted and written.
//     Two passes over the row, whatever k and the data.
//   - sort (k > 16384, up to k = n): the whole row is sorted by key, by
//     hand, in a bitonic network: each CTA sorts a 4096-key tile in
//     shared memory, then merge stages whose stride spans tiles run one
//     launch each over the whole (rows, 2^p) key array, and the strides
//     within a tile run in shared memory. The first k keys are written.
//     The reference reaches k = n in a filtered search that widens its
//     pool until the live set is exhausted (vector.py:772-810).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDigit = 12;                 // key bits per histogram pass
constexpr int kBins = 1 << kDigit;
constexpr int kSelectMaxK = 16384;         // select regime up to this k
constexpr int kCap = 4096;                 // boundary-bin keys sorted in smem
constexpr int kScanThreads = 512;          // hist / collect CTAs
constexpr int kPer = 16;                   // keys a thread loads per step
constexpr int kStep = kScanThreads * kPer; // 8192 keys a CTA step
constexpr int kThreads = 1024;             // finish and sort CTAs
constexpr int kTile = 4096;                // sort regime: keys per CTA tile
constexpr int kAux = kBins + 2;            // per row: histogram, 2 counts
constexpr size_t kFinishSmem =
    kBins * sizeof(uint32_t) + (kSelectMaxK + kCap) * sizeof(uint64_t);

enum Metric { kEuclidean = 0, kCosine = 1, kDotProduct = 2, kDistance = 3 };

__device__ __forceinline__ uint32_t orderable(float d) {
  const uint32_t b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ float epilogue(int metric, float x, float sq,
                                          float qs) {
  switch (metric) {
    case kEuclidean:
      return __fadd_rn(__fsub_rn(sq, __fmul_rn(2.0f, x)), qs);
    case kCosine:
      return __fsub_rn(
          1.0f, __fdiv_rn(x, fmaxf(__fmul_rn(__fsqrt_rn(sq), qs), 1e-12f)));
    case kDotProduct:
      return -x;
    default:
      return x;
  }
}

struct Args {
  const float* x;
  int64_t ldx;
  const float* sqnorm;       // per column of x, or null
  const uint8_t* valid;      // per column of x, or null
  const int32_t* col_index;  // (n,) columns of x, or null for j
  const float* qstat;        // per row, or null
  int metric;
  int n;
  int k;
  bool vec;  // no col_index, and x rows, sqnorm and valid load as vectors
};

__device__ __forceinline__ uint64_t make_key(int metric, float x, float sq,
                                             bool live, float qs, int j) {
  float d = metric == kDistance ? x : epilogue(metric, x, sq, qs);
  if (!live) d = __uint_as_float(0x7f800000u);  // +inf
  return ((uint64_t)orderable(d) << 32) | (uint32_t)j;
}

// The kPer keys this thread owns in the step at `base` of row `row`, and
// which of them lie before `end`. Every load of the step is issued before
// any key is formed. Vector mode: four float4 groups a thread, each warp
// on 512 contiguous bytes; otherwise kPer strided scalar loads.
__device__ __forceinline__ void load_keys(const Args& a, int row, float qs,
                                          int base, int end,
                                          uint64_t (&key)[kPer],
                                          bool (&in)[kPer]) {
  const int tid = threadIdx.x;
  const float* xr = a.x + row * a.ldx;
  if (a.vec) {
    constexpr int kG = kPer / 4;
    float4 xv[kG], sv[kG];
    uchar4 vv[kG];
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      const int g = (base >> 2) + u * kScanThreads + tid;
      const bool ok = 4 * g < end;
      xv[u] = ok ? __ldg(reinterpret_cast<const float4*>(xr) + g)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      sv[u] = ok && a.sqnorm
                  ? __ldg(reinterpret_cast<const float4*>(a.sqnorm) + g)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      vv[u] = ok && a.valid ? reinterpret_cast<const uchar4*>(a.valid)[g]
                            : make_uchar4(1, 1, 1, 1);
    }
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      const int j = 4 * ((base >> 2) + u * kScanThreads + tid);
      const bool ok = j < end;
      const float xs[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
      const float ss[4] = {sv[u].x, sv[u].y, sv[u].z, sv[u].w};
      const unsigned char vs[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        in[4 * u + e] = ok;
        key[4 * u + e] = make_key(a.metric, xs[e], ss[e], vs[e] != 0, qs, j + e);
      }
    }
    return;
  }
  float xs[kPer], ss[kPer];
  bool live[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = base + i * kScanThreads + tid;
    in[i] = j < end;
    const int c = in[i] ? (a.col_index ? a.col_index[j] : j) : 0;
    xs[i] = in[i] ? xr[c] : 0.f;
    ss[i] = in[i] && a.sqnorm ? a.sqnorm[c] : 0.f;
    live[i] = !(in[i] && a.valid) || a.valid[c];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    key[i] = make_key(a.metric, xs[i], ss[i], live[i], qs,
                      base + i * kScanThreads + tid);
}

// Adds one to hist[bin] for every lane with `ok`, one atomic per distinct
// bin in the warp. Every lane of the warp must call it.
__device__ __forceinline__ void hist_add(uint32_t* hist, bool ok,
                                         uint32_t bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? bin : 0xffffffffu);
  if (ok && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], (uint32_t)__popc(peers));
}

// Appends `key` to buf for every lane with `take`, one atomic per warp;
// buf and count in shared or global memory. Every lane of the warp must
// call it.
__device__ __forceinline__ void append(uint64_t* buf, uint32_t* count,
                                       bool take, uint64_t key) {
  const unsigned m = __ballot_sync(0xffffffffu, take);
  if (!m) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(count, (uint32_t)__popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) buf[base + __popc(m & ((1u << lane) - 1u))] = key;
}

// Block-wide: the bin b of hist[0, nbins) with below < k <= below +
// hist[b], where below is the count of bins under b. Needs the sum of
// hist to be >= k and blockDim.x a multiple of 32. Results in *bin and
// *below for every thread.
__device__ void find_bin(const uint32_t* hist, int nbins, uint32_t k,
                         uint32_t* warp_sums, uint32_t* bin,
                         uint32_t* below) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (nbins + blockDim.x - 1) / blockDim.x;
  const int lo = tid * per;
  uint32_t local = 0;
  for (int i = 0; i < per; ++i)
    if (lo + i < nbins) local += hist[lo + i];
  uint32_t incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t v = lane < nwarps ? warp_sums[lane] : 0;
    uint32_t s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane < nwarps) warp_sums[lane] = s - v;  // exclusive
  }
  __syncthreads();
  const uint32_t excl = warp_sums[warp] + incl - local;
  if (excl < k && k <= excl + local) {
    uint32_t run = excl;
    for (int i = 0; i < per; ++i) {
      const uint32_t c = hist[lo + i];
      if (run + c >= k) {
        *bin = (uint32_t)(lo + i);
        *below = run;
        break;
      }
      run += c;
    }
  }
  __syncthreads();
}

// Block-wide ascending bitonic sort of s[0, n), n a power of two.
__device__ void bitonic_smem(uint64_t* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const uint64_t x = s[lo], y = s[hi];
        if ((x > y) == asc) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_ceil(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// select regime ----------------------------------------------------------
// aux per row: the row's histogram (kBins), then the counts of the lower
// list (below) and of the bin's list. scratch per row: the lower list
// (kSelectMaxK keys), then the bin's list (up to n keys).

__global__ void __launch_bounds__(kScanThreads)
topk_hist_kernel(Args a, int chunk, uint32_t* __restrict__ aux) {
  __shared__ uint32_t hist[kBins];
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * chunk;
  const int c1 = min(a.n, c0 + chunk);
  const float qs = a.qstat ? a.qstat[row] : 0.0f;
  for (int i = threadIdx.x; i < kBins; i += kScanThreads) hist[i] = 0;
  __syncthreads();
  uint64_t key[kPer];
  bool in[kPer];
  for (int base = c0; base < c1; base += kStep) {
    load_keys(a, row, qs, base, c1, key, in);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      hist_add(hist, in[i], (uint32_t)(key[i] >> (64 - kDigit)));
  }
  __syncthreads();
  uint32_t* g = aux + (int64_t)row * kAux;
  for (int i = threadIdx.x; i < kBins; i += kScanThreads)
    if (hist[i]) atomicAdd(&g[i], hist[i]);
}

__global__ void __launch_bounds__(kScanThreads)
topk_collect_kernel(Args a, int chunk, uint32_t* __restrict__ aux,
                    uint64_t* __restrict__ scratch, int64_t scratch_ld) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t s_bin, s_below;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * chunk;
  const int c1 = min(a.n, c0 + chunk);
  const float qs = a.qstat ? a.qstat[row] : 0.0f;
  uint32_t* g = aux + (int64_t)row * kAux;
  for (int i = threadIdx.x; i < kBins; i += kScanThreads) hist[i] = g[i];
  __syncthreads();
  find_bin(hist, kBins, (uint32_t)a.k, warp_sums, &s_bin, &s_below);
  const uint64_t prefix = s_bin;
  uint64_t* lower = scratch + (int64_t)row * scratch_ld;
  uint64_t* group = lower + kSelectMaxK;
  uint64_t key[kPer];
  bool in[kPer];
  for (int base = c0; base < c1; base += kStep) {
    load_keys(a, row, qs, base, c1, key, in);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const uint64_t hi = key[i] >> (64 - kDigit);
      append(lower, &g[kBins], in[i] && hi < prefix, key[i]);
      append(group, &g[kBins + 1], in[i] && hi == prefix, key[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
topk_finish_kernel(int k, const uint32_t* __restrict__ aux,
                   const uint64_t* __restrict__ scratch, int64_t scratch_ld,
                   float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);
  uint64_t* A = reinterpret_cast<uint64_t*>(smem + kBins * sizeof(uint32_t));
  uint64_t* B = A + kSelectMaxK;
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t s_bin, s_below, s_na, s_nb;

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const uint32_t* g = aux + (int64_t)row * kAux;
  const uint32_t na0 = g[kBins], m0 = g[kBins + 1];
  const uint64_t* lower = scratch + (int64_t)row * scratch_ld;
  const uint64_t* S = lower + kSelectMaxK;
  for (int i = tid; i < (int)na0; i += kThreads) A[i] = lower[i];
  if (tid == 0) {
    s_na = na0;
    s_nb = 0;
  }
  uint32_t kk = (uint32_t)k - na0;  // keys still wanted from the group
  uint32_t m = m0;                  // keys in the group
  int shift = 64 - kDigit;
  uint64_t prefix = S[0] >> shift;  // the group's key bits so far
  __syncthreads();
  // narrow the group over its list until it fits in B; keys are unique,
  // so at the latest the full 64 bits leave one
  while (m > (uint32_t)kCap) {
    const int bits = shift < kDigit ? shift : kDigit;
    shift -= bits;
    const int nb = 1 << bits;
    for (int i = tid; i < nb; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < (int)m0; base += kThreads) {
      const int i = base + tid;
      const bool in = i < (int)m0;
      const uint64_t key = in ? S[i] : 0;
      const bool ok = in && (key >> (shift + bits)) == prefix;
      hist_add(hist, ok, (uint32_t)(key >> shift) & (uint32_t)(nb - 1));
    }
    __syncthreads();
    find_bin(hist, nb, kk, warp_sums, &s_bin, &s_below);
    kk -= s_below;
    m = hist[s_bin];
    prefix = (prefix << bits) | s_bin;
    __syncthreads();
  }
  // the group's keys under the prefix are in; those at it go to B
  for (int base = 0; base < (int)m0; base += kThreads) {
    const int i = base + tid;
    const bool in = i < (int)m0;
    const uint64_t key = in ? S[i] : 0;
    const uint64_t hi = key >> shift;
    append(A, &s_na, in && hi < prefix, key);
    append(B, &s_nb, in && hi == prefix, key);
  }
  __syncthreads();

  // the kk smallest of the group join the keys under it: k keys in all
  const int na = (int)s_na, nb = (int)s_nb;
  const int pb = pow2_ceil(nb);
  for (int i = nb + tid; i < pb; i += kThreads) B[i] = ~0ull;
  __syncthreads();
  bitonic_smem(B, pb);
  for (int i = tid; i < (int)kk; i += kThreads) A[na + i] = B[i];
  const int pk = pow2_ceil(k);
  for (int i = k + tid; i < pk; i += kThreads) A[i] = ~0ull;
  __syncthreads();
  bitonic_smem(A, pk);
  for (int i = tid; i < k; i += kThreads) {
    const uint64_t key = A[i];
    out_d[(int64_t)row * k + i] = from_orderable((uint32_t)(key >> 32));
    out_i[(int64_t)row * k + i] = (int32_t)(uint32_t)key;
  }
}

// sort regime ------------------------------------------------------------

__global__ void topk_keys_kernel(Args a, uint64_t* __restrict__ keys,
                                 int npad) {
  const int row = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= npad) return;
  uint64_t key = ~0ull;
  if (j < a.n) {
    const int c = a.col_index ? a.col_index[j] : j;
    key = make_key(a.metric, a.x[row * a.ldx + c],
                   a.sqnorm ? a.sqnorm[c] : 0.0f, !a.valid || a.valid[c],
                   a.qstat ? a.qstat[row] : 0.0f, j);
  }
  keys[(int64_t)row * npad + j] = key;
}

// One compare-exchange of the bitonic network on pair t of a row, for a
// merge of `size` at `stride`; i0 is the row's index of the pair's base.
__device__ __forceinline__ void cmp_swap(uint64_t* s, int t, int size,
                                         int stride, int i0) {
  const int lo = 2 * t - (t & (stride - 1));
  const int hi = lo + stride;
  const bool asc = ((i0 + lo) & size) == 0;
  const uint64_t x = s[lo], y = s[hi];
  if ((x > y) == asc) {
    s[lo] = y;
    s[hi] = x;
  }
}

// Sorts each tile of `tile` keys by every merge of size up to `tile`
// (first = true), or runs the strides below `tile` of the merge of
// `size` (first = false), in shared memory.
__global__ void __launch_bounds__(kThreads)
topk_tile_kernel(uint64_t* __restrict__ keys, int npad, int tile, int size,
                 bool first) {
  __shared__ uint64_t s[kTile];
  const int row = blockIdx.y;
  const int i0 = blockIdx.x * tile;
  uint64_t* g = keys + (int64_t)row * npad + i0;
  for (int i = threadIdx.x; i < tile; i += kThreads) s[i] = g[i];
  __syncthreads();
  const int from = first ? 2 : size;
  const int to = first ? tile : size;
  for (int sz = from; sz <= to; sz <<= 1) {
    for (int stride = (sz < tile ? sz : tile) >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (tile >> 1); t += kThreads)
        cmp_swap(s, t, sz, stride, i0);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += kThreads) g[i] = s[i];
}

__global__ void topk_global_step_kernel(uint64_t* __restrict__ keys, int npad,
                                        int size, int stride) {
  const int row = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (npad >> 1)) return;
  cmp_swap(keys + (int64_t)row * npad, t, size, stride, 0);
}

__global__ void topk_emit_kernel(const uint64_t* __restrict__ keys, int npad,
                                 int k, float* __restrict__ out_d,
                                 int32_t* __restrict__ out_i) {
  const int row = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const uint64_t key = keys[(int64_t)row * npad + i];
  out_d[(int64_t)row * k + i] = from_orderable((uint32_t)(key >> 32));
  out_i[(int64_t)row * k + i] = (int32_t)(uint32_t)key;
}

// Columns a row may have: its keys sort as a power of two that fits an int.
constexpr int kMaxN = 1 << 30;

// The kernels a call launches, named for vector_topk_kernel_name().
enum Kernel { kHist, kCollect, kFinish, kKeys, kTileSort, kGlobalStep, kEmit,
              kNumKernels };
const char* const kKernelName[kNumKernels] = {
    "topk_hist_kernel", "topk_collect_kernel", "topk_finish_kernel",
    "topk_keys_kernel", "topk_tile_kernel",    "topk_global_step_kernel",
    "topk_emit_kernel"};

int64_t pow2_ceil_host(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Calls f(kernel, size, stride) for each launch of one call on rows of n
// keys, in launch order: the one plan that vector_topk_launch runs and
// vector_topk_launch_counts reports. 1 <= k <= n <= kMaxN.
template <class F>
void for_each_launch(int n, int k, F&& f) {
  if (k <= kSelectMaxK) {
    f(kHist, 0, 0);
    f(kCollect, 0, 0);
    f(kFinish, 0, 0);
    return;
  }
  const int64_t npad = pow2_ceil_host(n);
  const int64_t tile = npad < kTile ? npad : kTile;
  f(kKeys, 0, 0);
  f(kTileSort, 0, 0);
  for (int64_t size = tile << 1; size <= npad; size <<= 1) {
    for (int64_t stride = size >> 1; stride >= tile; stride >>= 1)
      f(kGlobalStep, (int)size, (int)stride);
    f(kTileSort, (int)size, 0);
  }
  f(kEmit, 0, 0);
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

}  // namespace

extern "C" {

// The largest k the select regime takes; larger k sorts the row.
int vector_topk_select_max_k() { return kSelectMaxK; }

// Keys of scratch the launch needs per row.
int64_t vector_topk_scratch_per_row(int n) {
  const int64_t npad = pow2_ceil_host(n);
  const int64_t sel = (int64_t)kSelectMaxK + n;
  return npad > sel ? npad : sel;
}

// uint32 words of aux the launch needs per row.
int vector_topk_aux_per_row() { return kAux; }

// The largest n (columns per row) a launch takes.
int vector_topk_max_n() { return kMaxN; }

// Writes into counts[i] how often one launch on rows of n columns with
// this k starts kernel i (named by vector_topk_kernel_name(i)). Returns the
// number of kernels, or -1 for an n or k the launch refuses.
int vector_topk_launch_counts(int n, int k, int* counts) {
  if (n < 1 || n > kMaxN || k < 1 || k > n) return -1;
  for (int i = 0; i < kNumKernels; ++i) counts[i] = 0;
  for_each_launch(n, k, [&](int kernel, int, int) { ++counts[kernel]; });
  return kNumKernels;
}

// The name of kernel i, as the card's trace shows it.
const char* vector_topk_kernel_name(int i) {
  return i >= 0 && i < kNumKernels ? kKernelName[i] : nullptr;
}

// out_d (rows, k) f32 and out_i (rows, k) i32; scratch holds rows *
// vector_topk_scratch_per_row(n) keys and aux rows *
// vector_topk_aux_per_row() words, both overwritten. Returns 0 or a
// cudaError_t.
int vector_topk_launch(const float* x, int64_t ldx, const float* sqnorm,
                       const uint8_t* valid, const int32_t* col_index,
                       const float* qstat, int metric, int rows, int n, int k,
                       float* out_d, int32_t* out_i, uint64_t* scratch,
                       uint32_t* aux, cudaStream_t stream) {
  if (rows < 0 || rows > 65535 || n < 1 || n > kMaxN || k < 1 || k > n ||
      metric < 0 || metric > kDistance)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const bool vec = !col_index && ldx % 4 == 0 && n % 4 == 0 &&
                   aligned(x, 16) && (!sqnorm || aligned(sqnorm, 16)) &&
                   (!valid || aligned(valid, 4));
  const Args a{x, ldx, sqnorm, valid, col_index, qstat, metric, n, k, vec};
  const int64_t ld = vector_topk_scratch_per_row(n);
  // select regime: about two CTAs per SM over all rows, chunks a multiple
  // of a step
  dim3 grid(1, rows);
  int chunk = 0;
  if (k <= kSelectMaxK) {
    static int sms = 0;
    if (!sms) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (sms < 1) sms = 132;
    }
    const int steps = (n + kStep - 1) / kStep;
    int splits = (2 * sms + rows - 1) / rows;
    if (splits > steps) splits = steps;
    chunk = (steps + splits - 1) / splits * kStep;
    grid.x = (n + chunk - 1) / chunk;
  }
  // sort regime: rows of npad <= ld keys each
  const int npad = (int)pow2_ceil_host(n);
  const int tile = npad < kTile ? npad : kTile;
  cudaError_t e = cudaSuccess;
  for_each_launch(n, k, [&](int kernel, int size, int stride) {
    if (e != cudaSuccess) return;
    switch (kernel) {
      case kHist:
        e = cudaMemsetAsync(aux, 0, (size_t)rows * kAux * sizeof(uint32_t),
                            stream);
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(topk_finish_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kFinishSmem);
        if (e == cudaSuccess)
          topk_hist_kernel<<<grid, kScanThreads, 0, stream>>>(a, chunk, aux);
        break;
      case kCollect:
        topk_collect_kernel<<<grid, kScanThreads, 0, stream>>>(a, chunk, aux,
                                                               scratch, ld);
        break;
      case kFinish:
        topk_finish_kernel<<<rows, kThreads, kFinishSmem, stream>>>(
            k, aux, scratch, ld, out_d, out_i);
        break;
      case kKeys:
        topk_keys_kernel<<<dim3((npad + 255) / 256, rows), 256, 0, stream>>>(
            a, scratch, npad);
        break;
      case kTileSort:  // size 0: sort each tile; else merge stage `size`
        topk_tile_kernel<<<dim3(npad / tile, rows), kThreads, 0, stream>>>(
            scratch, npad, tile, size, size == 0);
        break;
      case kGlobalStep:
        topk_global_step_kernel<<<dim3((npad / 2 + 255) / 256, rows), 256, 0,
                                  stream>>>(scratch, npad, size, stride);
        break;
      case kEmit:
        topk_emit_kernel<<<dim3((k + 255) / 256, rows), 256, 0, stream>>>(
            scratch, npad, k, out_d, out_i);
        break;
    }
  });
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
