// KV2 for Hopper: the IVF slab scan, reading each probed slab in place.
//
// Replaces the gather and the distances of the device program of
// dgraph_tpu/models/vector.py:232 _ivf_probe (jitted by :259 _jit_ivf
// and vmapped by :266 _jit_ivf_batch): sub = flat_vecs[sidx] (M, 128, d)
// materialised per query, dd = _distances(sub, ...), rows < 0 -> +inf.
// Centroid scoring and both top-k steps are left to torch.matmul and KV1
// (csrc/vector_topk.cu).
//
// What it computes. For query i < nq and probed slab m < M, with
// slab = sidx[i, m] and s < 128:
//   dd[i, m * 128 + s] = +inf                  where flat_rows[slab, s] < 0
//                      = epilogue(dot, flat_sq[slab, s], qstat[i]) otherwise
// with dot = flat_vecs[slab, s, :] . Q[i, :] and the metric epilogue of
// KV1 (euclidean (0), cosine (1), dotproduct (2)), each op an _rn
// intrinsic. The dot's sum runs in this kernel's order (lanes over d,
// then a butterfly), not torch.matmul's, so dd agrees with the plain
// version to a tolerance, not bit for bit.
//
// What bounds it. Each probed slab row is read once: M * 128 * d * 4
// bytes per query (about 200 MB at 1M x 768 with ~500 slabs probed),
// against 3.35 TB/s. The dot is a GEMV, 2 flops per 4 bytes read, far
// below the card's 67 TFLOP/s of f32: memory-bound.
//
// What the design does about that. The reference materialised the
// (M, 128, d) gather, so a batch had to be chunked to fit (vector.py:1651);
// here nothing is materialised but dd. One CTA per (slab, query), eight
// warps; the query sits in shared memory, each warp takes rows of the
// slab, and its lanes read a row's d floats as float4, neighbouring lanes
// on neighbouring addresses, so a row is one contiguous 3 KB stream.
// Rows past a cell's end (flat_rows < 0) are not read at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 128;   // rows per slab (vector.py _SLAB)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 12288;  // 48 KB of query in shared memory

enum Metric { kEuclidean = 0, kCosine = 1, kDotProduct = 2 };

__device__ __forceinline__ float epilogue(int metric, float x, float sq,
                                          float qs) {
  switch (metric) {
    case kEuclidean:
      return __fadd_rn(__fsub_rn(sq, __fmul_rn(2.0f, x)), qs);
    case kCosine:
      return __fsub_rn(
          1.0f, __fdiv_rn(x, fmaxf(__fmul_rn(__fsqrt_rn(sq), qs), 1e-12f)));
    default:
      return -x;
  }
}

__global__ void __launch_bounds__(kThreads)
slab_scan_kernel(const float* __restrict__ flat_vecs,
                 const float* __restrict__ flat_sq,
                 const int32_t* __restrict__ flat_rows,
                 const int32_t* __restrict__ sidx,
                 const float* __restrict__ Q, const float* __restrict__ qstat,
                 int metric, int M, int d, float* __restrict__ dd) {
  extern __shared__ __align__(16) float q[];
  const int m = blockIdx.x;
  const int i = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qg = Q + (int64_t)i * d;
  for (int c = threadIdx.x; c < d; c += kThreads) q[c] = qg[c];
  __syncthreads();

  const int64_t slab = sidx[(int64_t)i * M + m];
  const float qs = qstat[i];
  const bool vec4 = (d & 3) == 0;
  float* out = dd + ((int64_t)i * M + m) * kSlab;
  for (int s = warp; s < kSlab; s += kWarps) {
    const int64_t r = slab * kSlab + s;
    if (flat_rows[r] < 0) {  // the same for the whole warp
      if (lane == 0) out[s] = __uint_as_float(0x7f800000u);
      continue;
    }
    const float* v = flat_vecs + r * d;
    float acc = 0.0f;
    if (vec4) {
      const float4* v4 = reinterpret_cast<const float4*>(v);
      const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll 4
      for (int c = lane; c < (d >> 2); c += 32) {
        const float4 a = __ldg(v4 + c);
        const float4 b = q4[c];
        acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
    } else {
      for (int c = lane; c < d; c += 32) acc += __ldg(v + c) * q[c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[s] = epilogue(metric, acc, flat_sq[r], qs);
  }
}

}  // namespace

extern "C" {

// dd: (nq, M * 128) f32, every element written. Returns 0 or a
// cudaError_t.
int ivf_slab_scan_launch(const float* flat_vecs, const float* flat_sq,
                         const int32_t* flat_rows, const int32_t* sidx,
                         const float* Q, const float* qstat, int metric,
                         int nq, int M, int d, float* dd,
                         cudaStream_t stream) {
  if (nq < 0 || nq > 65535 || M < 0 || d < 1 || d > kMaxDim || metric < 0 ||
      metric > kDotProduct)
    return (int)cudaErrorInvalidValue;
  if (nq == 0 || M == 0) return 0;
  slab_scan_kernel<<<dim3(M, nq), kThreads, d * sizeof(float), stream>>>(
      flat_vecs, flat_sq, flat_rows, sidx, Q, qstat, metric, M, d, dd);
  return (int)cudaGetLastError();
}

}  // extern "C"
