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
// distances equal the plain PyTorch version's bit for bit (the GEMM in
// front runs with TF32 off, ops/vector_topk.py f32_matmul).
//
// Order. Each element becomes a 64-bit key, (orderable(d) << 32) | j,
// where orderable() maps the float's bits to a uint32 that sorts in the
// total order. Keys are unique, so "the k smallest keys" is exactly the
// reference's answer, ties and all, any correct algorithm gives the same
// bits, and no step needs to be stable.
//
// What bounds it. The function reads each element of the row once (4
// bytes, plus the L2-resident sqnorm and valid per column) and writes
// 8 k bytes: memory-bound, at 3.35 TB/s. At the batched brute search (64
// queries over a 2^20-row corpus) that is 268 MB of dot, about 0.08 ms.
// A single served row (one query, 2^17 or 67,840 columns) moves well under
// a megabyte, so there the bound is the latency of one launch.
//
// What the design does about that. Two regimes, switched in this file
// alone (onepass(): k <= kOnePassMaxK, and k times the row's CTAs within
// a budget that grows with the rows, as `chip_smoke.py --crossover`
// measured on the card). In both, a row is cut into chunks so that the
// grid fills the card in one wave of about two CTAs per SM whatever the
// number of rows, and each thread keeps 16 loads in flight, as float4
// where the row allows.
//   - one pass (small k), one launch, x read once. Each CTA streams its
//     chunk and compares each key with a running threshold, the CTA's
//     current k-th smallest key; most keys are rejected by their
//     distance's 32 bits alone. Keys below it go into a candidate buffer
//     in shared memory (a ballot and one shared atomic per warp, no
//     global atomics), which holds a whole step, so the block meets once
//     a step to count it (each warp's count in a slot, summed by one warp
//     reduction). A buffer past a step's worth of room is sorted (bitonic,
//     with the stages inside a warp's 64 keys on the warp's own barrier)
//     and merged by rank into the CTA's sorted k-list, and the threshold
//     tightens. The first threshold comes before any key is taken
//     (k <= 1024): the k-th smallest of every thread's one or two smallest
//     keys of the first step, each warp's sorted in registers, so the
//     first sort holds about k keys, not a step. Each CTA writes its
//     k-list to scratch; the row's last CTA, which knows it is last by an
//     atomic ticket that it then resets (so no memset), reads the other
//     lists through the same threshold, a step of keys at a time, and
//     writes the output. Tied rows need no special case: the column half
//     of the key keeps the threshold strict.
//   - radix (the other k, up to k = n), no step in one CTA over more
//     than its share. The row's keys, as (32 + ceil(log2 n))-bit values
//     (orderable(d) << cb) | j, are narrowed 12 bits a launch: every CTA
//     builds a histogram of the next digit over its chunk's keys that
//     match the prefix so far and adds it to the row's histogram; the
//     row's last CTA (ticket) finds the digit that holds the k-th key,
//     records the prefix and clears the histogram. A pass whose row is
//     already settled returns at once (with k = n none runs). Then a
//     collect pass appends exactly the k keys at or under the final prefix
//     (one global atomic per CTA and 2048 keys), and those k keys alone
//     are sorted: 4096-key tiles in shared memory, then merge passes
//     (merge path, every thread searching its own start) that double the
//     sorted runs, the last one writing the output. x is read once per
//     pass (three settle a Gaussian row; a row of equal distances needs
//     all of them), and n padded keys are never written or sorted.
//   The persistent state (tickets, the row histograms, the collect
//   counters) is zero between calls: every kernel that uses a word puts
//   it back to zero, so the caller zeroes it once, when it allocates it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;               // streaming CTAs
constexpr int kPer = 16;                    // keys a thread loads per step
constexpr int kStep = kThreads * kPer;      // 8192 keys a CTA step
constexpr int kGroup = kThreads * 4;        // keys between buffer checks
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = kStep + 2048;          // one-pass candidate buffer, keys
constexpr int kSpill = 4096;                // collect's buffer, keys
constexpr int kOnePassMaxK = 2048;          // one-pass regime up to this k ...
constexpr int kMergeBudget = 2048;          // ... and k * CTAs a row up to this
                                            // times max(1, rows / 8)
constexpr int kSeedMaxK = 2 * kThreads;    // k seeded from thread minima
constexpr int kDigit = 12;                  // radix bits per pass
constexpr int kBins = 1 << kDigit;
constexpr int kRowState = 2 + kBins;        // radix: ticket, count, histogram
constexpr int kSortTile = 4096;             // keys a tile CTA sorts in smem
constexpr int kSortThreads = 1024;
constexpr int kMergeThreads = 256;
constexpr int kMergePer = 8;                // outputs per merging thread
constexpr int kMaxN = 1 << 30;              // columns: j fits 30 bits
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ uint32_t ord_of(int metric, float x, float sq,
                                           bool live, float qs) {
  float d = metric == kDistance ? x : epilogue(metric, x, sq, qs);
  if (!live) d = __uint_as_float(0x7f800000u);  // +inf
  return orderable(d);
}

// The column of key i (of kPer) that this thread owns in the step at
// `base`. Vector mode: four float4 groups a thread, each warp on 512
// contiguous bytes; otherwise kPer strided scalars.
__device__ __forceinline__ int col_of(bool vec, int base, int i) {
  const int tid = threadIdx.x;
  return vec ? 4 * ((base >> 2) + (i >> 2) * kThreads + tid) + (i & 3)
             : base + i * kThreads + tid;
}

// The orderable distances of the kPer keys this thread owns in the step
// at `base` of row `row` (garbage past `end`). Every load of the step is
// issued before any distance is formed.
__device__ __forceinline__ void load_ord(const Args& a, int row, float qs,
                                         int base, int end,
                                         uint32_t (&o)[kPer]) {
  const int tid = threadIdx.x;
  const float* xr = a.x + row * a.ldx;
  if (a.vec) {
    constexpr int kG = kPer / 4;
    float4 xv[kG], sv[kG];
    uchar4 vv[kG];
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      const int g = (base >> 2) + u * kThreads + tid;
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
      const float xs[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
      const float ss[4] = {sv[u].x, sv[u].y, sv[u].z, sv[u].w};
      const unsigned char vs[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[4 * u + e] = ord_of(a.metric, xs[e], ss[e], vs[e] != 0, qs);
    }
    return;
  }
  float xs[kPer], ss[kPer];
  bool live[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = base + i * kThreads + tid;
    const bool in = j < end;
    const int c = in ? (a.col_index ? a.col_index[j] : j) : 0;
    xs[i] = in ? xr[c] : 0.f;
    ss[i] = in && a.sqnorm ? a.sqnorm[c] : 0.f;
    live[i] = !(in && a.valid) || a.valid[c];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    o[i] = ord_of(a.metric, xs[i], ss[i], live[i], qs);
}

// Adds one to hist[bin] for every lane with `ok`, one atomic per distinct
// bin in the warp. Every lane of the warp must call it.
__device__ __forceinline__ void hist_add(uint32_t* hist, bool ok,
                                         uint32_t bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? bin : 0xffffffffu);
  if (ok && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], (uint32_t)__popc(peers));
}

// Appends `key` to the shared buffer for every lane with `take`, one
// shared atomic per warp. Every lane of the warp must call it. Returns the
// warp's count of keys appended.
__device__ __forceinline__ uint32_t append(uint64_t* buf, uint32_t* count,
                                           bool take, uint64_t key) {
  const unsigned m = __ballot_sync(0xffffffffu, take);
  if (!m) return 0;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(count, (uint32_t)__popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) buf[base + __popc(m & ((1u << lane) - 1u))] = key;
  return (uint32_t)__popc(m);
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

// Block-wide ascending bitonic sort of s[0, n), n a power of two, ending
// in a __syncthreads. A stage of stride <= 32 moves keys only within
// blocks of 64 that one warp owns (pairs t of warp w lie in keys [64 w',
// 64 w' + 64)), so between two such stages the warp's own barrier is
// enough; the block's is taken before and after each stage of stride >= 64.
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
      // the next stage: (size, stride / 2), or (2 size, size) after stride 1
      const int next = stride > 1 ? stride >> 1 : size;
      if (stride >= 64 || next >= 64 || (stride == 1 && size == n))
        __syncthreads();
      else
        __syncwarp();
    }
  }
  if (n == 1) __syncthreads();
}

__device__ __forceinline__ int pow2_ceil(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// How many of the sorted s[0, n) are below x.
__device__ __forceinline__ int count_below(const uint64_t* s, int n,
                                           uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void emit(uint64_t key, float* out_d,
                                     int32_t* out_i, int64_t at) {
  out_d[at] = from_orderable((uint32_t)(key >> 32));
  out_i[at] = (int32_t)(uint32_t)key;
}

__device__ __forceinline__ uint64_t load_cg(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

// one-pass regime ----------------------------------------------------------

// A CTA's running selection: the sorted k-list (nl keys) in shared memory,
// its double, the candidate buffer and the threshold: keys below it are
// taken (the list's k-th key, or before the list first fills a seed with
// at least k keys under it, or ~0). Every thread holds the same copy.
struct Sel {
  uint64_t* buf;
  uint64_t* list;
  uint64_t* spare;
  uint32_t* count;  // keys in buf
  int k;
  int nl;
  uint64_t thr;
};

// Block-wide, after a __syncthreads: sorts the buffer and merges it into
// the list, keeping the k smallest; empties the buffer.
__device__ __forceinline__ void flush(Sel& s) {
  const int nb = (int)*s.count;
  if (nb == 0) return;
  const int pb = pow2_ceil(nb);
  for (int i = nb + threadIdx.x; i < pb; i += blockDim.x) s.buf[i] = ~0ull;
  __syncthreads();
  bitonic_smem(s.buf, pb);
  // merge by rank: a key's place is its index plus the count of the other
  // list's keys below it (keys are unique)
  for (int i = threadIdx.x; i < s.nl; i += blockDim.x) {
    const int r = i + count_below(s.buf, nb, s.list[i]);
    if (r < s.k) s.spare[r] = s.list[i];
  }
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int r = i + count_below(s.list, s.nl, s.buf[i]);
    if (r < s.k) s.spare[r] = s.buf[i];
  }
  __syncthreads();
  uint64_t* t = s.list;
  s.list = s.spare;
  s.spare = t;
  s.nl = min(s.k, s.nl + nb);
  s.thr = s.nl == s.k ? s.list[s.k - 1] : ~0ull;
  if (threadIdx.x == 0) *s.count = 0;
  __syncthreads();
}

// The buffer's exact fill, counted at a barrier: each warp's lane 0 puts
// the keys its warp appended since the last count into slot[par][warp]
// before the barrier, every thread adds up the slots after it. The next
// count uses the other slots, so no slot is written again before every
// thread has read it. Every thread of the block must call it.
__device__ __forceinline__ int count_fill(uint32_t (*slot)[kWarps], int& par,
                                          uint32_t& taken) {
  if ((threadIdx.x & 31) == 0) slot[par][threadIdx.x >> 5] = taken;
  taken = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned sum =
      __reduce_add_sync(0xffffffffu, lane < kWarps ? slot[par][lane] : 0u);
  par ^= 1;
  return (int)sum;
}

// How many of the sorted s[0, 32) are below x: five halvings and a last
// compare, without branches, so that many such counts overlap.
__device__ __forceinline__ int count_below32(const uint64_t* s, uint64_t x) {
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (s[pos + step - 1] < x) pos += step;
  return pos + (s[pos] < x);
}

// k <= kSeedMaxK: a first threshold from the first step's keys, before
// any is taken. Each thread gives its `lists` (1 or 2) smallest keys (~0
// for none); each warp sorts each of them in registers and puts them in
// tmp. The k-th smallest of all these has at least k keys at or under
// it, most of them the step's smallest, so the first step takes little
// more than k keys (ties are split by the column half of the key).
// Returned as the key above it (a strict compare), or ~0 where there are
// fewer than k. Every thread of the block must call it, after a
// __syncthreads; tmp holds 2 kThreads keys.
__device__ __noinline__ uint64_t seed_threshold(uint64_t m0, uint64_t m1,
                                                int lists, int k, uint64_t* tmp,
                                                unsigned long long* s_seed) {
  const int lane = threadIdx.x & 31;
  uint64_t m[2] = {m0, m1};
#pragma unroll
  for (int l = 0; l < 2; ++l) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const uint64_t other = __shfl_xor_sync(
            0xffffffffu, (unsigned long long)m[l], stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        m[l] = keep_min ? (other < m[l] ? other : m[l])
                        : (other > m[l] ? other : m[l]);
      }
    }
    tmp[l * kThreads + threadIdx.x] = m[l];
  }
  __syncthreads();
  for (int l = 0; l < lists; ++l) {
    if (m[l] == ~0ull) continue;
    int rank = 0;
    for (int w = 0; w < lists * kWarps; ++w)
      rank += count_below32(tmp + 32 * w, m[l]);
    if (rank == k - 1) *s_seed = m[l];  // keys are unique: one thread
  }
  __syncthreads();
  return *s_seed == ~0ull ? ~0ull : *s_seed + 1;
}

// partial: per row, gridDim.x lists of k keys (unused with one CTA a row);
// tickets: per row, zero between calls.
__global__ void __launch_bounds__(kThreads, 2)
topk_onepass_kernel(Args a, int chunk, uint64_t* __restrict__ partial,
                    uint32_t* __restrict__ tickets, float* __restrict__ out_d,
                    int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) uint64_t smem[];
  __shared__ uint32_t s_count;
  __shared__ uint32_t s_slot[2][kWarps];
  __shared__ unsigned long long s_seed;
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * chunk;
  const int c1 = min(a.n, c0 + chunk);
  const float qs = a.qstat ? a.qstat[row] : 0.0f;
  const int kp = pow2_ceil(a.k);
  Sel s{smem, smem + kBuf, smem + kBuf + kp, &s_count, a.k, 0, ~0ull};
  if (tid == 0) {
    s_count = 0;
    s_seed = ~0ull;
  }
  __syncthreads();
  int fill = 0, par = 0;
  uint32_t taken = 0;  // keys this warp appended since the last count

  // Until the list holds k keys (the threshold is ~0) every key is taken,
  // so the fill is counted every 2048 keys and the list filled at once;
  // from then on, once a step. A key is rejected by its distance alone
  // when that lies above the threshold's.
  for (int base = c0; base < c1; base += kStep) {
    uint32_t o[kPer];
    load_ord(a, row, qs, base, c1, o);
    if (base == c0 && a.k <= kSeedMaxK) {
      uint64_t m0 = ~0ull, m1 = ~0ull;  // the two smallest keys
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = col_of(a.vec, base, i);
        const uint64_t key =
            j < c1 ? ((uint64_t)o[i] << 32) | (uint32_t)j : ~0ull;
        m1 = key < m1 ? (key < m0 ? m0 : key) : m1;
        m0 = key < m0 ? key : m0;
      }
      s.thr = seed_threshold(m0, m1, a.k > kThreads ? 2 : 1, a.k, s.buf,
                             &s_seed);
    }
    const bool warm = s.thr == ~0ull;
#pragma unroll
    for (int g = 0; g < kPer; g += 4) {
      const uint32_t top = (uint32_t)(s.thr >> 32);
      bool c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = o[g + e] <= top;
      if (__any_sync(0xffffffffu, c[0] || c[1] || c[2] || c[3])) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = col_of(a.vec, base, g + e);
          const uint64_t key = ((uint64_t)o[g + e] << 32) | (uint32_t)j;
          taken += append(s.buf, s.count, c[e] && j < c1 && key < s.thr, key);
        }
      }
      if (warm) {  // until the list first holds k keys
        fill += count_fill(s_slot, par, taken);
        if (fill > kBuf - kStep || (s.nl < s.k && fill + s.nl >= s.k)) {
          flush(s);
          fill = 0;
        }
      }
    }
    if (!warm) {
      fill += count_fill(s_slot, par, taken);
      if (fill > kBuf - kStep || (s.nl < s.k && fill + s.nl >= s.k)) {
        flush(s);
        fill = 0;
      }
    }
  }
  __syncthreads();
  flush(s);
  fill = 0;

  const int64_t out0 = (int64_t)row * a.k;
  if (gridDim.x > 1) {
    uint64_t* part = partial + (int64_t)row * gridDim.x * a.k;
    uint64_t* mine = part + (int64_t)blockIdx.x * a.k;
    for (int i = tid; i < a.k; i += kThreads)
      mine[i] = i < s.nl ? s.list[i] : ~0ull;
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&tickets[row], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // the row's last CTA: the other CTAs' lists, read kStep keys at a
    // time with every load in flight, through the same threshold
    const int others = (gridDim.x - 1) * a.k;
    const int mine_at = blockIdx.x * a.k;
    for (int base = 0; base < others; base += kStep) {
      uint64_t key[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int at = base + i * kThreads + tid;  // past this CTA's own list
        const int from = at + (at >= mine_at ? a.k : 0);
        key[i] = at < others ? load_cg(part + from) : ~0ull;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        taken += append(s.buf, s.count, key[i] < s.thr, key[i]);
      fill += count_fill(s_slot, par, taken);
      if (fill > kBuf - kStep) {
        flush(s);
        fill = 0;
      }
    }
    __syncthreads();
    flush(s);
    if (tid == 0) tickets[row] = 0;
  }
  for (int i = tid; i < a.k; i += kThreads)
    emit(s.list[i], out_d, out_i, out0 + i);
}

// radix regime -------------------------------------------------------------
// state per row (zero between calls): [0] ticket, [1] collect count, then
// the row's histogram (kBins). info per row (scratch): [0] the prefix of
// the k-th key so far, [1] kk | bits left below the prefix << 32 |
// settled << 48, where kk is the rank of the k-th key among the keys
// under the prefix.

__device__ __forceinline__ uint64_t radix_key(uint32_t o, int j, int cb) {
  return ((uint64_t)o << cb) | (uint32_t)j;
}

__global__ void __launch_bounds__(kThreads)
topk_radix_kernel(Args a, int chunk, int pass, int cb,
                  uint32_t* __restrict__ state, uint64_t* __restrict__ info) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t s_bin, s_below;
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  uint64_t* inf = info + 2 * (int64_t)row;
  uint64_t prefix = 0;
  int above = 32 + cb;  // the prefix covers the key's bits from `above` up
  uint32_t kk = (uint32_t)a.k;
  if (pass > 0) {
    const uint64_t w = inf[1];
    if (w >> 48) return;  // settled by an earlier pass
    prefix = inf[0];
    kk = (uint32_t)w;
    above = (int)((w >> 32) & 0xffffu);
  }
  const int shift = above > kDigit ? above - kDigit : 0;
  const int nb = 1 << (above - shift);
  for (int i = tid; i < nb; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int c0 = blockIdx.x * chunk;
  const int c1 = min(a.n, c0 + chunk);
  const float qs = a.qstat ? a.qstat[row] : 0.0f;
  for (int base = c0; base < c1; base += kStep) {
    uint32_t o[kPer];
    load_ord(a, row, qs, base, c1, o);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = col_of(a.vec, base, i);
      const uint64_t rk = radix_key(o[i], j, cb);
      const bool ok = j < c1 && (rk >> above) == prefix;
      if (__any_sync(0xffffffffu, ok))
        hist_add(hist, ok, (uint32_t)(rk >> shift) & (uint32_t)(nb - 1));
    }
  }
  __syncthreads();
  uint32_t* g = state + (int64_t)row * kRowState;
  uint32_t* gh = g + 2;
  for (int i = tid; i < nb; i += kThreads)
    if (hist[i]) atomicAdd(&gh[i], hist[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&g[0], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the row's last CTA: the digit of the k-th key; the histogram and the
  // ticket go back to zero
  for (int i = tid; i < nb; i += kThreads) {
    hist[i] = __ldcg(&gh[i]);
    gh[i] = 0;
  }
  __syncthreads();
  find_bin(hist, nb, kk, warp_sums, &s_bin, &s_below);
  if (tid == 0) {
    const uint32_t left = kk - s_below;
    const bool settled = left == hist[s_bin] || shift == 0;
    inf[0] = (prefix << (above - shift)) | s_bin;
    inf[1] = left | ((uint64_t)shift << 32) | ((uint64_t)settled << 48);
    g[0] = 0;
  }
}

// Appends the k keys at or under the settled prefix to keys (rows, k), in
// no order; with k = n, every key (no radix pass ran).
__global__ void __launch_bounds__(kThreads)
topk_collect_kernel(Args a, int chunk, int cb, uint32_t* __restrict__ state,
                    const uint64_t* __restrict__ info,
                    uint64_t* __restrict__ keys) {
  __shared__ uint64_t buf[kSpill];
  __shared__ uint32_t s_count, s_base;
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const bool all = a.k == a.n;
  const uint64_t prefix = all ? 0 : info[2 * (int64_t)row];
  const int above =
      all ? 63 : (int)((info[2 * (int64_t)row + 1] >> 32) & 0xffffu);
  uint32_t* g = state + (int64_t)row * kRowState;
  uint64_t* out = keys + (int64_t)row * a.k;
  const int c0 = blockIdx.x * chunk;
  const int c1 = min(a.n, c0 + chunk);
  const float qs = a.qstat ? a.qstat[row] : 0.0f;
  if (tid == 0) s_count = 0;
  __syncthreads();
  int fill = 0;  // an upper bound of the buffer's keys, as in one pass
  // block-wide, after a __syncthreads: the buffer to `out`, one global
  // atomic for the whole buffer
  auto spill = [&]() {
    const uint32_t nbuf = s_count;
    if (nbuf == 0) return;
    if (tid == 0) s_base = atomicAdd(&g[1], nbuf);
    __syncthreads();
    for (uint32_t i = tid; i < nbuf; i += kThreads) out[s_base + i] = buf[i];
    __syncthreads();
    if (tid == 0) s_count = 0;
    __syncthreads();
  };
  for (int base = c0; base < c1; base += kStep) {
    uint32_t o[kPer];
    load_ord(a, row, qs, base, c1, o);
#pragma unroll
    for (int gi = 0; gi < kPer; gi += 4) {
      bool t[4];
      uint64_t key[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = col_of(a.vec, base, gi + e);
        key[e] = ((uint64_t)o[gi + e] << 32) | (uint32_t)j;
        t[e] = j < c1 && (radix_key(o[gi + e], j, cb) >> above) <= prefix;
      }
      const bool any = t[0] || t[1] || t[2] || t[3];
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) append(buf, &s_count, t[e], key[e]);
      }
      fill += 4 * __syncthreads_count(any);
      if (fill >= kSpill - kGroup) {
        spill();
        fill = 0;
      }
    }
  }
  __syncthreads();
  spill();
  __threadfence();
  if (tid == 0) s_last = atomicAdd(&g[0], 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last && tid == 0) {
    g[1] = 0;
    g[0] = 0;
  }
}

// Sorts each kSortTile-key tile of keys (rows, k) in shared memory; with a
// single tile (k <= kSortTile) it writes the output instead.
__global__ void __launch_bounds__(kSortThreads)
topk_tile_kernel(uint64_t* __restrict__ keys, int k, float* __restrict__ out_d,
                 int32_t* __restrict__ out_i) {
  __shared__ uint64_t s[kSortTile];
  const int row = blockIdx.y;
  const int i0 = blockIdx.x * kSortTile;
  const int len = min(kSortTile, k - i0);
  const int pl = pow2_ceil(len);
  uint64_t* g = keys + (int64_t)row * k + i0;
  for (int i = threadIdx.x; i < pl; i += kSortThreads)
    s[i] = i < len ? g[i] : ~0ull;
  __syncthreads();
  bitonic_smem(s, pl);
  for (int i = threadIdx.x; i < len; i += kSortThreads) {
    if (out_d)
      emit(s[i], out_d, out_i, (int64_t)row * k + i);
    else
      g[i] = s[i];
  }
}

// One merge pass over keys (rows, k) sorted in runs of `width`: each pair
// of runs merged into dst, or into the output when out_d is given. Each
// thread finds where its kMergePer outputs start on the merge path.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const uint64_t* __restrict__ src, uint64_t* __restrict__ dst,
                  int k, int width, float* __restrict__ out_d,
                  int32_t* __restrict__ out_i) {
  const int row = blockIdx.y;
  const int64_t i0 =
      ((int64_t)blockIdx.x * kMergeThreads + threadIdx.x) * kMergePer;
  if (i0 >= k) return;
  const int64_t r0 = (int64_t)row * k;
  const int64_t pair = i0 / (2 * (int64_t)width) * (2 * (int64_t)width);
  const uint64_t* A = src + r0 + pair;
  const int la = (int)min((int64_t)width, k - pair);
  const uint64_t* B = A + la;
  const int lb = (int)max((int64_t)0, min((int64_t)width, k - pair - width));
  const int diag = (int)(i0 - pair);
  int lo = max(0, diag - lb), hi = min(diag, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (A[mid] < B[diag - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  int ai = lo, bi = diag - lo;
  for (int e = 0; e < kMergePer && i0 + e < k; ++e) {
    const bool take_a = bi >= lb || (ai < la && A[ai] < B[bi]);
    const uint64_t key = take_a ? A[ai++] : B[bi++];
    if (out_d)
      emit(key, out_d, out_i, r0 + i0 + e);
    else
      dst[r0 + i0 + e] = key;
  }
}

// host ----------------------------------------------------------------------

// The kernels a call launches, named for vector_topk_kernel_name().
enum Kernel { kOnePass, kRadix, kCollect, kTile, kMerge, kNumKernels };
const char* const kKernelName[kNumKernels] = {
    "topk_onepass_kernel", "topk_radix_kernel", "topk_collect_kernel",
    "topk_tile_kernel", "topk_merge_kernel"};

// Bits of a column index for rows of n columns.
int col_bits(int n) {
  int b = 1;
  while ((1ll << b) < n) ++b;
  return b;
}

int radix_passes(int n) { return (32 + col_bits(n) + kDigit - 1) / kDigit; }

int sm_count() {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (!sms[dev]) {
    int m = 0;
    cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = m > 0 ? m : 132;
  }
  return sms[dev];
}

// The chunk of a row each CTA streams (a multiple of a step), for about
// two CTAs per SM over all rows; *ctas: CTAs per row.
int chunk_of(int rows, int n, int* ctas) {
  const int steps = (n + kStep - 1) / kStep;
  int splits = 2 * sm_count() / rows;  // one wave: a partial second wave
                                       // doubles the time of the first
  if (splits > steps) splits = steps;
  if (splits < 1) splits = 1;
  const int chunk = (steps + splits - 1) / splits * kStep;
  *ctas = (n + chunk - 1) / chunk;
  return chunk;
}

// The regimes' switch, measured on the card (chip_smoke.py --crossover):
// one pass wins while its per-CTA sorts (about k keys) and the last CTA's
// merge (k keys from each CTA of the row) cost less than the radix
// regime's passes over the row, whose fixed cost grows with the rows.
bool onepass(int rows, int n, int k) {
  if (k > kOnePassMaxK) return false;
  int ctas = 1;
  chunk_of(rows, n, &ctas);
  const int64_t scale = rows / 8 > 1 ? rows / 8 : 1;
  return (int64_t)k * ctas <= kMergeBudget * scale;
}

// Calls f(kernel, arg) for each launch of one call on rows x n keys, in
// launch order: the one plan that vector_topk_launch runs and
// vector_topk_launch_counts reports. arg: the radix pass, or the merge's
// run width. 1 <= k <= n <= kMaxN.
template <class F>
void for_each_launch(int rows, int n, int k, F&& f) {
  if (onepass(rows, n, k)) {
    f(kOnePass, 0);
    return;
  }
  if (k < n)  // with k = n every key is selected
    for (int p = 0; p < radix_passes(n); ++p) f(kRadix, p);
  f(kCollect, 0);
  f(kTile, 0);
  for (int64_t w = kSortTile; w < k; w <<= 1) f(kMerge, (int)w);
}

size_t onepass_smem(int k) {
  int kp = 1;
  while (kp < k) kp <<= 1;
  return (size_t)(kBuf + 2 * kp) * sizeof(uint64_t);
}

// Sets the one-pass kernel's dynamic shared memory limit, once a device.
cudaError_t onepass_attribute() {
  static bool set[kMaxDevices] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (set[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      topk_onepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)onepass_smem(kOnePassMaxK));
  if (e == cudaSuccess) set[dev] = true;
  return e;
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

bool valid_shape(int rows, int n, int k) {
  return rows >= 0 && rows <= 65535 && n >= 1 && n <= kMaxN && k >= 1 &&
         k <= n;
}

}  // namespace

extern "C" {

// The largest k the one-pass regime takes; a larger k goes by radix.
int vector_topk_onepass_max_k() { return kOnePassMaxK; }

// Whether a launch on rows x n with this k takes the one-pass regime.
int vector_topk_onepass(int rows, int n, int k) {
  return valid_shape(rows, n, k) && onepass(rows > 0 ? rows : 1, n, k);
}

// Keys of scratch a launch on rows x n with this k needs: the CTAs'
// k-lists (one pass, with several CTAs a row), or the row info and two
// buffers of k keys a row (radix). -1 for a shape the launch refuses.
int64_t vector_topk_scratch_keys(int rows, int n, int k) {
  if (!valid_shape(rows, n, k)) return -1;
  if (!onepass(rows > 0 ? rows : 1, n, k))
    return (int64_t)rows * (2 + 2 * (int64_t)k);
  int ctas = 1;
  chunk_of(rows > 0 ? rows : 1, n, &ctas);
  return ctas > 1 ? (int64_t)rows * ctas * k : 0;
}

// uint32 words of persistent state a launch on `rows` rows with this k
// needs. The state must be zero before the first launch; every launch
// leaves it zero.
int64_t vector_topk_state_words(int rows, int n, int k) {
  if (!valid_shape(rows, n, k)) return -1;
  return onepass(rows > 0 ? rows : 1, n, k) ? (int64_t)rows
                                            : (int64_t)rows * kRowState;
}

// The largest n (columns per row) a launch takes.
int vector_topk_max_n() { return kMaxN; }

// Writes into counts[i] how often one launch on rows x n with this k
// starts kernel i (named by vector_topk_kernel_name(i)). Returns the
// number of kernels, or -1 for a shape the launch refuses.
int vector_topk_launch_counts(int rows, int n, int k, int* counts) {
  if (!valid_shape(rows, n, k) || rows < 1) return -1;
  for (int i = 0; i < kNumKernels; ++i) counts[i] = 0;
  for_each_launch(rows, n, k, [&](int kernel, int) { ++counts[kernel]; });
  return kNumKernels;
}

// The name of kernel i, as the card's trace shows it.
const char* vector_topk_kernel_name(int i) {
  return i >= 0 && i < kNumKernels ? kKernelName[i] : nullptr;
}

// out_d (rows, k) f32 and out_i (rows, k) i32; scratch holds
// vector_topk_scratch_keys(rows, n, k) keys (overwritten); state holds
// vector_topk_state_words(rows, n, k) words, zero before and after. Returns 0
// or a cudaError_t.
int vector_topk_launch(const float* x, int64_t ldx, const float* sqnorm,
                       const uint8_t* valid, const int32_t* col_index,
                       const float* qstat, int metric, int rows, int n, int k,
                       float* out_d, int32_t* out_i, uint64_t* scratch,
                       uint32_t* state, cudaStream_t stream) {
  if (!valid_shape(rows, n, k) || metric < 0 || metric > kDistance)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const bool vec = !col_index && ldx % 4 == 0 && n % 4 == 0 &&
                   aligned(x, 16) && (!sqnorm || aligned(sqnorm, 16)) &&
                   (!valid || aligned(valid, 4));
  const Args a{x, ldx, sqnorm, valid, col_index, qstat, metric, n, k, vec};
  int ctas = 1;
  const int chunk = chunk_of(rows, n, &ctas);
  const dim3 grid(ctas, rows);
  const int cb = col_bits(n);
  // radix: the row info, then two key buffers
  uint64_t* info = scratch;
  uint64_t* bufs[2] = {scratch + 2 * (int64_t)rows,
                       scratch + 2 * (int64_t)rows + (int64_t)rows * k};
  int cur = 0;
  cudaError_t e = cudaSuccess;
  for_each_launch(rows, n, k, [&](int kernel, int arg) {
    if (e != cudaSuccess) return;
    switch (kernel) {
      case kOnePass:
        e = onepass_attribute();
        if (e == cudaSuccess)
          topk_onepass_kernel<<<grid, kThreads, onepass_smem(k), stream>>>(
              a, chunk, scratch, state, out_d, out_i);
        break;
      case kRadix:
        topk_radix_kernel<<<grid, kThreads, 0, stream>>>(a, chunk, arg, cb,
                                                         state, info);
        break;
      case kCollect:
        topk_collect_kernel<<<grid, kThreads, 0, stream>>>(a, chunk, cb, state,
                                                           info, bufs[0]);
        break;
      case kTile: {
        const bool last = k <= kSortTile;
        topk_tile_kernel<<<dim3((k + kSortTile - 1) / kSortTile, rows),
                           kSortThreads, 0, stream>>>(
            bufs[0], k, last ? out_d : nullptr, out_i);
        break;
      }
      case kMerge: {
        const bool last = 2 * (int64_t)arg >= k;
        const int per_cta = kMergeThreads * kMergePer;
        topk_merge_kernel<<<dim3((k + per_cta - 1) / per_cta, rows),
                            kMergeThreads, 0, stream>>>(
            bufs[cur], bufs[cur ^ 1], k, arg, last ? out_d : nullptr, out_i);
        cur ^= 1;
        break;
      }
    }
    if (e == cudaSuccess) e = cudaGetLastError();
  });
  return (int)e;
}

}  // extern "C"
