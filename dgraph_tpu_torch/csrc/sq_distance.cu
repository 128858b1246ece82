// KV3 for Hopper: the squared euclidean distance of every row of a shard
// to one query, in one pass over the shard.
//
// Replaces the per-shard distance of the XLA program of
// dgraph_tpu/parallel/mesh.py:154 sharded_topk (its line :167,
// d2 = ((V_tile - q[None, :]) ** 2).sum(axis=1)), which the port had run
// as three torch passes (a difference, a square, a sum) over each shard.
// The masked top-k after it stays KV1's (csrc/vector_topk.cu, metric
// "distance", the invalid rows at +inf).
//
// What it computes. For r < rows:
//   d2[r] = sum_j (V[r, j] - q[j])^2      in float32
// difference first, then the square, as the reference writes it (not the
// |v|^2 - 2 v.q + |q|^2 expansion, which cancels differently). Row r of V
// starts ld floats after row r - 1; its d floats are contiguous. The sum
// runs in this kernel's order (a lane's terms, then a butterfly over the
// warp), not torch's, so d2 agrees with the plain version to a tolerance,
// not bit for bit. A NaN term makes the sum NaN, an infinite one +inf,
// as in the plain version.
//
// What bounds it. V is read once: rows * d * 4 bytes (3.07 GB for
// 1M x 768 float32, 0.917 ms at 3.35 TB/s). Three flops a float against
// the card's 67 TFLOP/s of f32 take a thirtieth of that: memory-bound.
//
// What the design does about that. One warp a row, eight rows a CTA at a
// time, the CTAs walking the rows with a grid stride so that the query,
// staged once per CTA in shared memory, is reused over many rows. The
// lanes read a row as float4 from its first 16-byte boundary on,
// neighbouring lanes on neighbouring addresses (a warp instruction moves
// 512 contiguous bytes), with the scalars before that boundary and after
// the last whole float4 read one a lane: a row of any d, at any
// alignment (a view of a wider matrix, d % 4 != 0), takes the same pass.
// With every row 16-byte aligned the query is read from shared memory as
// float4 too. A CTA of 256 threads and a few KB of shared memory lets the
// SM hold 64 warps, each with its row's loads in flight, well above what
// it takes to keep the memory busy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows in flight a CTA, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 8;  // CTAs an SM holds at 2048 threads
constexpr int kMaxSharedDim = 12288;  // 48 KB of query in shared memory

__device__ __forceinline__ float sq(float v, float q) {
  const float t = v - q;
  return t * t;
}

// kSharedQ: q staged in shared memory (d <= kMaxSharedDim); else it is
// read through the read-only cache.
template <bool kSharedQ>
__global__ void __launch_bounds__(kThreads)
sq_distance_kernel(const float* __restrict__ V, int64_t ld,
                   const float* __restrict__ q, int64_t rows, int d,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) float qs[];
  const float* qq = q;
  if (kSharedQ) {
    for (int j = threadIdx.x; j < d; j += kThreads) qs[j] = q[j];
    __syncthreads();
    qq = qs;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + warp; r < rows;
       r += (int64_t)gridDim.x * kWarps) {
    const float* v = V + r * ld;
    // the floats before v's first 16-byte boundary (v is 4-byte aligned)
    const int head =
        min(d, (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(v) & 15)) & 15) >> 2));
    const int n4 = (d - head) >> 2;
    const int tail = head + (n4 << 2);
    float acc = 0.0f;
    if (lane < head) acc = sq(__ldg(v + lane), qq[lane]);
    const float4* v4 = reinterpret_cast<const float4*>(v + head);
    if (kSharedQ && head == 0) {
      const float4* q4 = reinterpret_cast<const float4*>(qq);
#pragma unroll 4
      for (int c = lane; c < n4; c += 32) {
        const float4 a = __ldg(v4 + c);
        const float4 b = q4[c];
        acc += sq(a.x, b.x) + sq(a.y, b.y) + sq(a.z, b.z) + sq(a.w, b.w);
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < n4; c += 32) {
        const float4 a = __ldg(v4 + c);
        const float* b = qq + head + 4 * c;
        acc += sq(a.x, b[0]) + sq(a.y, b[1]) + sq(a.z, b[2]) + sq(a.w, b[3]);
      }
    }
    if (tail + lane < d) acc += sq(__ldg(v + tail + lane), qq[tail + lane]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[r] = acc;
  }
}

}  // namespace

extern "C" {

// V: rows of d floats, row r at V + r * ld; q: d floats; out: rows
// floats, every one written. Runs on the current device. Returns 0 or a
// cudaError_t.
int sq_distance_launch(const float* V, int64_t ld, const float* q,
                       int64_t rows, int d, float* out, cudaStream_t stream) {
  if (rows < 0 || d < 0 || ld < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (rows + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  if (d <= kMaxSharedDim)
    sq_distance_kernel<true><<<blocks, kThreads, d * sizeof(float), stream>>>(
        V, ld, q, rows, d, out);
  else
    sq_distance_kernel<false><<<blocks, kThreads, 0, stream>>>(V, ld, q, rows,
                                                                d, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
