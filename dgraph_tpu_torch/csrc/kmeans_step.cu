// KV4 for Hopper: one shard's Lloyd step after its GEMM — the
// assignment, then the per-centroid sums and counts, with no float atomic.
//
// Replaces the per-shard XLA program of dgraph_tpu/parallel/mesh.py:191
// sharded_kmeans_step (its lines :203-210, iterated by :221
// sharded_ivf_train), which the port had run as torch.argmin and two
// index_add_ calls. The GEMM dot = X @ C^T in front stays torch.matmul
// with TF32 off (ops/vector_topk.py f32_matmul), as the reference left it
// to XLA; the psum over shards and the update after it stay in
// parallel/mesh.py.
//
// What it computes. For X (n, d) float32 (row r at X + r * ldx), weights
// w (n,) float32 (the reference's valid.astype(float32)), C (c, d) and
// dot (n, c) (row r at dot + r * ldd):
//   xsq[r]    = sum_j X[r, j]^2            csq[k] = sum_j C[k, j]^2
//   d2[r, k]  = (xsq[r] - 2 dot[r, k]) + csq[k]
//   assign[r] = argmin_k d2[r, k]
//   sums[k]   = sum over rows r with assign[r] == k of X[r] * w[r]
//   cnts[k]   = sum over the same rows of w[r]
// d2 is written with _rn intrinsics in the reference's order, so nvcc
// contracts nothing into an FMA. The argmin is jnp.argmin's: the first
// NaN if the row has one, else the smallest, ties to the lower centroid.
// xsq and csq are sums in this kernel's order, not torch's, so a row
// within a few ulps of a tie may be assigned otherwise than by the plain
// version. An empty cluster gets sums 0 and count 0.
//
// Order of the sums. The rows of a cluster are added in row order, one
// product x * w at a time, as the reference's segment_sum adds them on
// the host: no atomics, so two launches on the same inputs give equal
// bits, and the sums equal the host's whenever the assignment does.
// The rows are put in cluster order first by a stable counting sort:
//   1. prep: csq, and the per-block histograms zeroed;
//   2. assign: a warp a row (the warps of a full card striding over the
//      rows) reads the row of X (for xsq) and of dot, writes assign[r]
//      and counts the row in its block's histogram, a block being
//      kRowsPerBlock rows (integer atomics: their sum does not depend on
//      their order);
//   3. scan_blocks: a warp a cluster turns its count in each block into
//      the block's exclusive offset, and writes the cluster's total;
//   4. scan_clusters: one CTA turns the totals into each cluster's start;
//   5. scatter: a CTA a block stages its rows' assignments and (up to
//      kScatterSharedMax clusters) its cursors in shared memory; one warp
//      walks the rows in order, 32 at a time, groups the lanes of one
//      cluster (__match_any_sync) and writes each row id at its
//      cluster's cursor plus its rank in the group;
//   6. sums: a CTA for each (cluster, 128 columns) walks the cluster's
//      rows in order, a thread a column.
//
// What bounds it. X read once and dot read once, w and C once, the sums,
// counts and assignment written once: at emb_small on 4 shards (100,000 x
// 768 against 256 centroids) 307 MB of X and 102 MB of dot, about 0.12 ms
// at 3.35 TB/s; 3 operations a dot against 67 TFLOP/s take far less:
// memory-bound. This kernel reads X twice (the assignment's xsq, then the
// sums), so it moves about 1.75 times the bound's bytes.
//
// What the design does about that. Both passes over X stream it: the
// assignment as float4 from each row's first 16-byte boundary on (a row
// of any d at any alignment), neighbouring lanes on neighbouring
// addresses; the sums a row's 128 columns as 512 contiguous bytes, with
// the cluster's row ids staged in shared memory and eight loads in flight
// a thread. The scans and the scatter touch 4 bytes a row. A cluster
// holding most rows is summed by few CTAs in row order; a chunked sum
// (deterministic, in another order) is open.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kAssignWarps = 8;
constexpr int kAssignThreads = 32 * kAssignWarps;
constexpr int kRowsPerBlock = 256;  // rows a histogram block (and scatter CTA) counts
constexpr int kScatterThreads = 256;
constexpr int kScatterSharedMax = 8192;  // clusters whose cursors a scatter CTA keeps in smem
constexpr int64_t kHistWords = int64_t(1) << 24;  // histogram words at most
constexpr int kSumThreads = 128;  // columns a CTA of the sums
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// rows a block takes: kRowsPerBlock, doubled until the histograms (one
// word a cluster and block) fit kHistWords or one block holds every row
int64_t rows_per_block(int64_t n, int64_t c) {
  int64_t r = kRowsPerBlock;
  while (r < n && ((n + r - 1) / r) * c > kHistWords) r *= 2;
  return r;
}

int64_t blocks_of(int64_t n, int64_t c) {
  const int64_t r = rows_per_block(n, c);
  return (n + r - 1) / r;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// candidate (v, k) before (bv, bk) in jnp.argmin's order: NaN first,
// then ascending, ties to the lower index
__device__ __forceinline__ bool before(float v, int k, float bv, int bk) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || k < bk);
  return v < bv || (v == bv && k < bk);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(256)
kmeans_prep_kernel(const float* __restrict__ C, int64_t ldc, int c, int d,
                   float* __restrict__ csq, int* __restrict__ hist,
                   int64_t hist_words) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < hist_words; i += stride) hist[i] = 0;
  const int lane = threadIdx.x & 31;
  for (int64_t k = tid >> 5; k < c; k += stride >> 5) {
    const float* row = C + k * ldc;
    float acc = 0.0f;
    for (int j = lane; j < d; j += 32) acc += row[j] * row[j];
    acc = warp_sum(acc);
    if (lane == 0) csq[k] = acc;
  }
}

// a warp a row, the warps striding over the rows; row r is counted in
// histogram block r / rows_per
__global__ void __launch_bounds__(kAssignThreads)
kmeans_assign_kernel(const float* __restrict__ X, int64_t ldx,
                     const float* __restrict__ dot, int64_t ldd,
                     const float* __restrict__ csq, int64_t n, int c, int d,
                     int64_t rows_per, int64_t nb, int* __restrict__ assign,
                     int* __restrict__ hist) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kAssignWarps;
  for (int64_t r = (int64_t)blockIdx.x * kAssignWarps + (threadIdx.x >> 5); r < n;
       r += warps) {
    // xsq: the floats before the row's first 16-byte boundary one a lane,
    // then float4, then the tail one a lane (as csrc/sq_distance.cu)
    const float* x = X + r * ldx;
    const int head = min(
        d, (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(x) & 15)) & 15) >> 2));
    const int n4 = (d - head) >> 2;
    const int tail = head + (n4 << 2);
    float acc = 0.0f;
    if (lane < head) acc = x[lane] * x[lane];
    const float4* x4 = reinterpret_cast<const float4*>(x + head);
#pragma unroll 4
    for (int i = lane; i < n4; i += 32) {
      const float4 a = __ldg(x4 + i);
      acc += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
    }
    if (tail + lane < d) acc += x[tail + lane] * x[tail + lane];
    const float xsq = warp_sum(acc);
    // the argmin of the row, a lane over every 32nd centroid, then the warp
    const float* dr = dot + r * ldd;
    float best = INFINITY;
    int bk = 0x7fffffff;
#pragma unroll 4
    for (int k = lane; k < c; k += 32) {
      const float v = __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.0f, __ldg(dr + k))), csq[k]);
      if (before(v, k, best, bk)) best = v, bk = k;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, o);
      const int ok = __shfl_xor_sync(kFull, bk, o);
      if (before(ov, ok, best, bk)) best = ov, bk = ok;
    }
    if (lane == 0) {
      assign[r] = bk;
      atomicAdd(hist + (int64_t)bk * nb + r / rows_per, 1);
    }
  }
}

// hist[k * nb + b]: block b's rows of cluster k -> their exclusive offset
// among the cluster's rows; tot[k]: the cluster's rows
__global__ void __launch_bounds__(256)
kmeans_scan_blocks_kernel(int* __restrict__ hist, int64_t nb, int c,
                          int* __restrict__ tot) {
  const int lane = threadIdx.x & 31;
  const int64_t k = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (k >= c) return;
  int* h = hist + k * nb;
  int carry = 0;
  for (int64_t base = 0; base < nb; base += 32) {
    const int64_t i = base + lane;
    const int v = i < nb ? h[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (i < nb) h[i] = carry + x - v;
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) tot[k] = carry;
}

// start[0..c): the clusters' totals -> their exclusive offsets; start[c]
// the sum. One CTA of kScanThreads.
__global__ void __launch_bounds__(kScanThreads)
kmeans_scan_clusters_kernel(int* __restrict__ start, int c) {
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < c; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < c ? start[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      warp_tot[lane] = s;
    }
    __syncthreads();
    if (i < c) start[i] = carry + (warp ? warp_tot[warp - 1] : 0) + x - v;
    carry += warp_tot[31];
    __syncthreads();  // warp_tot is written again in the next chunk
  }
  if (threadIdx.x == 0) start[c] = carry;
}

// a CTA a histogram block: its rows' assignments staged in shared memory
// kScatterThreads at a time, then its first warp walks them in order, 32
// at a time, writing each row id at its cluster's cursor (the cluster's
// start plus the block's offset, advanced as rows are placed; in shared
// memory with kSharedCursor, else in hist) plus its rank among the
// lanes of the same cluster (__match_any_sync)
template <bool kSharedCursor>
__global__ void __launch_bounds__(kScatterThreads)
kmeans_scatter_kernel(const int* __restrict__ assign, int* __restrict__ hist,
                      const int* __restrict__ start, int64_t n, int c,
                      int64_t rows_per, int64_t nb, int* __restrict__ order) {
  extern __shared__ int smem[];
  int* chunk = smem;                    // kScatterThreads assignments
  int* cur = smem + kScatterThreads;    // c cursors (kSharedCursor)
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.x;
  const int64_t lo = b * rows_per;
  const int64_t hi = min64(n, lo + rows_per);
  const unsigned below = (1u << lane) - 1u;
  if (kSharedCursor)
    for (int k = threadIdx.x; k < c; k += kScatterThreads)
      cur[k] = start[k] + hist[(int64_t)k * nb + b];
  for (int64_t base = lo; base < hi; base += kScatterThreads) {
    __syncthreads();  // the cursors set, the last chunk walked
    const int64_t rt = base + threadIdx.x;
    chunk[threadIdx.x] = rt < hi ? assign[rt] : -1;
    __syncthreads();
    if (threadIdx.x >= 32) continue;
    for (int off = 0; off < kScatterThreads && base + off < hi; off += 32) {
      const int64_t r = base + off + lane;
      const bool live = r < hi;
      const int k = chunk[off + lane];
      const unsigned group = __match_any_sync(kFull, k);
      int* cursor = nullptr;
      int at = 0;
      if (live) {
        cursor = kSharedCursor ? cur + k : hist + (int64_t)k * nb + b;
        at = (kSharedCursor ? 0 : start[k]) + *cursor;
        order[at + __popc(group & below)] = (int)r;
      }
      __syncwarp();
      if (live && lane == __ffs(group) - 1) *cursor += __popc(group);
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kSumThreads)
kmeans_sums_kernel(const float* __restrict__ X, int64_t ldx,
                   const float* __restrict__ w, const int* __restrict__ order,
                   const int* __restrict__ start, int d,
                   float* __restrict__ sums, float* __restrict__ cnts) {
  __shared__ int rows_s[kSumThreads];
  __shared__ float w_s[kSumThreads];
  const int64_t k = blockIdx.x;
  const int j = blockIdx.y * kSumThreads + threadIdx.x;
  const bool counts = blockIdx.y == 0 && threadIdx.x == 0;
  const int lo = start[k], hi = start[k + 1];
  float acc = 0.0f, cnt = 0.0f;
  for (int base = lo; base < hi; base += kSumThreads) {
    const int m = min(kSumThreads, hi - base);
    __syncthreads();  // the last chunk's rows are read by every thread
    if (threadIdx.x < m) {
      const int r = order[base + threadIdx.x];
      rows_s[threadIdx.x] = r;
      w_s[threadIdx.x] = w[r];
    }
    __syncthreads();
    if (j < d) {
      const float* col = X + j;
#pragma unroll 8
      for (int t = 0; t < m; ++t)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(col + (int64_t)rows_s[t] * ldx), w_s[t]));
    }
    if (counts)
      for (int t = 0; t < m; ++t) cnt = __fadd_rn(cnt, w_s[t]);
  }
  if (j < d) sums[k * d + j] = acc;
  if (counts) cnts[k] = cnt;
}

}  // namespace

extern "C" {

// int32 words of scratch a launch on n rows and c centroids takes: the
// histograms, the starts, the row order and csq.
int64_t kmeans_step_scratch_words(int64_t n, int64_t c) {
  if (n < 0 || c < 1) return -1;
  return blocks_of(n, c) * c + (c + 1) + n + c;
}

// X: n rows of d floats, row r at X + r * ldx; w: n floats; C: c rows of d
// floats at ldc; dot: n rows of c floats at ldd. sums (c, d) contiguous,
// cnts (c,) and assign (n,): every element written. scratch:
// kmeans_step_scratch_words(n, c) words. Runs on the current device.
// Returns 0 or a cudaError_t.
int kmeans_step_launch(const float* X, int64_t ldx, const float* w,
                       const float* C, int64_t ldc, const float* dot,
                       int64_t ldd, int64_t n, int c, int d, float* sums,
                       float* cnts, int* assign, int* scratch,
                       cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX || c < 1 || d < 0 || ldx < 0 || ldc < 0 || ldd < 0)
    return (int)cudaErrorInvalidValue;
  const int slices = d > 0 ? (d + kSumThreads - 1) / kSumThreads : 1;
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows_per = rows_per_block(n, c);
  const int64_t nb = (n + rows_per - 1) / rows_per;
  int* hist = scratch;
  int* start = hist + nb * c;
  int* order = start + (c + 1);
  float* csq = reinterpret_cast<float*>(order + n);

  const int64_t prep_work = nb * c > (int64_t)c * 32 ? nb * c : (int64_t)c * 32;
  int64_t prep_blocks = (prep_work + 255) / 256;
  if (prep_blocks > (int64_t)sms * 8) prep_blocks = (int64_t)sms * 8;
  kmeans_prep_kernel<<<(unsigned)prep_blocks, 256, 0, stream>>>(C, ldc, c, d, csq,
                                                                hist, nb * c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n > 0) {
    const int64_t want = (n + kAssignWarps - 1) / kAssignWarps;
    const int64_t cap = (int64_t)sms * (2048 / kAssignThreads);
    kmeans_assign_kernel<<<(unsigned)(want < cap ? want : cap), kAssignThreads, 0, stream>>>(
        X, ldx, dot, ldd, csq, n, c, d, rows_per, nb, assign, hist);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  kmeans_scan_blocks_kernel<<<(unsigned)(((int64_t)c * 32 + 255) / 256), 256, 0, stream>>>(
      hist, nb, c, start);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kmeans_scan_clusters_kernel<<<1, kScanThreads, 0, stream>>>(start, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n > 0) {
    if (c <= kScatterSharedMax)
      kmeans_scatter_kernel<true><<<(unsigned)nb, kScatterThreads,
                                    (kScatterThreads + c) * sizeof(int), stream>>>(
          assign, hist, start, n, c, rows_per, nb, order);
    else
      kmeans_scatter_kernel<false><<<(unsigned)nb, kScatterThreads,
                                     kScatterThreads * sizeof(int), stream>>>(
          assign, hist, start, n, c, rows_per, nb, order);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  kmeans_sums_kernel<<<dim3((unsigned)c, (unsigned)slices), kSumThreads, 0, stream>>>(
      X, ldx, w, order, start, d, sums, cnts);
  return (int)cudaGetLastError();
}

}  // extern "C"
