// setop_rows (K2 + K3) for Hopper: intersect and difference of sorted
// rows, membership and stable compaction fused into one single-pass
// kernel over a ragged (CSR) buffer.
//
// Replaces, in the JAX package, the XLA programs of
// dgraph_tpu/ops/setops.py: _searchsorted (:50) and membership (:61), K2,
// and compact (:73) with its fusions intersect (:87) and difference (:96),
// K3, as dgraph_tpu/query/dispatch.py runs them: vmapped over pow2 buckets
// of (A, LA, B, LB) pairs (_get_jitted :887, _run_bucket :911), or against
// one shared b (_get_jitted_shared :781, in_axes=(0, 0, None, None)).
//
// What it computes. A is a buffer of P positions cut into m rows: row i
// holds positions [off[i], off[i+1]) (ragged, off has m + 1 entries,
// off[0] = 0, off[m] = P), or [i * pa, (i + 1) * pa) of which the first
// LA[i] are valid (padded, off null). Row i is searched in its own range
// of B: range id = rid[i] (or i * rid_step), a (start, length) pair of
// the range table (or start id * b_stride and length LB[id]). Then
//   keep(p) = p valid and     A[p] in the range     (intersect)
//   keep(p) = p valid and not A[p] in the range     (difference)
//   keep(p) = p valid and keep_mask[p] != 0         (compaction)
// and the kept words come out in input order: ragged, out[out_off[i] ..
// out_off[i + 1]) holds row i's; padded, out[i * pa ..] holds row i's
// first, UINT32_MAX after them (a memset before the kernel) and
// cnt[i] = out_off[i + 1] - out_off[i] counts them: the (out, cnt)
// contract of setops.intersect, difference and compact. Uids are the bits
// of int32, compared unsigned. Rows and ranges are sorted ascending (the
// reference's precondition). Validity is judged by index against the
// lengths, never by value, so 0xFFFFFFFF stays a legal uid and padding of
// any value is never read as an element.
//
// What bounds it. Bytes: A's positions read once, the kept words and the
// m + 1 offsets written once (padded: the n * pa output words), and of B
// only the sectors the searches need. The compares, about log2(length of
// the range) an element, cost less than the element's own 4 bytes.
//
// Design. One launch for every row length; A is read once.
//   - Tiles of 2048 positions, taken from a ticket counter (not blockIdx)
//     by CTAs that loop until the tiles run out, so that a CTA only ever
//     waits on tiles that running CTAs hold. A warp takes 8 chunks of 32
//     positions; a lane loads one word a chunk, so each load is one
//     128-byte line.
//   - Searches run in shared memory. When all of B fits (up to kWholeMax
//     words: every shared b of the read path) each CTA stages B once with
//     cp.async and searches there. Otherwise a tile that lies in one row
//     stages the window of its range between lower_bound(first word) and
//     upper_bound(last word), found by a warp 32 probes a round; a window
//     over kWindowMax words, or a tile over several rows when B does not
//     fit, searches global memory, and counts the tile in counters[0].
//     The tile's rows (their starts and ranges) are staged in shared
//     memory too, and a lane's 8 searches (its words' rows, then their
//     membership) run in lockstep, so that 8 chains of dependent loads
//     overlap.
//   - Ballots give each kept element its place in its chunk; a scan over
//     the tile's 64 chunks its place in the tile. Across tiles, a
//     decoupled look-back: a tile publishes its aggregate, then a warp
//     reads its predecessors' status words 32 at a time (acquire) back to
//     the nearest inclusive prefix and publishes its own (release). The
//     status word is one 64-bit word: a state in 2 bits, the global count
//     G (the ragged place) in 31, and the count since the last row start
//     R (the padded place) in 31, so a segmented scan rides with the
//     plain one. Padded rows of at most 2048 take tiles of whole rows
//     instead, whose places and counts are their own: no look-back.
//   - The status words and the ticket belong to the call: the caller
//     allocates them with the outputs and the launch zeroes them on the
//     call's stream, so concurrent calls share nothing.
// No sort, cumsum or nonzero runs in it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 8;                  // chunks of 32 positions a warp takes
constexpr int kChunks = kWarps * kPer;   // 64 a tile
constexpr int kTile = 32 * kChunks;      // 2048 positions
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kWholeMax = 48 * 1024;     // words of B staged whole (192 KB)
constexpr int kWindowMax = 8 * 1024;     // words of a tile's window of B (32 KB)
constexpr int kRowCap = 1024;            // rows of a tile staged in shared memory
constexpr int kMinCtas = 4;              // CTAs an SM holds at once (64 registers a thread)
constexpr int kMaxDevices = 64;

enum { kIntersect = 0, kDifference = 1, kCompact = 2 };
enum { kSmemWhole = 0, kSmemWindow = 1, kGlobal = 2, kNone = 3 };
// states of a tile's status word (bits 62-63); 0: nothing published yet
constexpr unsigned long long kAgg = 1, kAggSeg = 2, kPrefix = 3;
constexpr unsigned long long kMask31 = 0x7FFFFFFFull;

struct Args {
  const uint32_t* A;
  const int32_t* off;      // ragged: m + 1 row offsets; null: padded rows of pa
  const int32_t* LA;       // padded: valid length a row; null: all pa valid
  const uint8_t* keep;     // compaction: the mask at each position
  const uint32_t* B;
  const int32_t* rid;      // range id a row; null: row * rid_step
  const int32_t* rstart;   // range starts (stride rstep); null: id * b_stride
  const int32_t* rlen;     // range lengths (stride rstep)
  uint32_t* out;
  int32_t* out_off;        // m + 1
  int32_t* cnt;            // padded: m counts; ragged: null
  unsigned long long* status;  // one word a tile, zeroed
  int32_t* counters;       // [0] tiles that searched global memory, [1] ticket; zeroed
  int64_t nB, b_stride;
  int m, pa, P, tiles, rid_step, rstep, bcap, op, whole;
  int span, aligned;  // positions a tile; tiles hold whole padded rows (no look-back)
};

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long pack(unsigned long long state, int r, int g) {
  return (state << 62) | ((unsigned long long)(unsigned)r << 31) | (unsigned long long)(unsigned)g;
}

// n words from global src to shared dst by every thread of the CTA, with
// cp.async; each thread waits for its own copies (the caller syncs).
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The first i in [0, n) with x[i] > q (upper) or x[i] >= q (lower), n if
// none, x sorted ascending in global memory; the whole warp searches, 32
// probes a round, so about log32(n) dependent loads. Every lane must call
// it with the same arguments.
template <typename T>
__device__ int warp_bound(const T* __restrict__ x, int n, T q, bool upper) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int len = hi - lo;
    const int step = (len + 31) / 32;
    const int at = lo + lane * step;
    bool p = true;  // probes past hi count as past the answer
    if (at < hi) {
      const T v = __ldg(x + at);
      p = upper ? v > q : v >= q;
    }
    const unsigned ball = __ballot_sync(kFull, p);
    if (ball == 0) {  // every probe before the answer
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(ball) - 1;
    if (f == 0) break;  // x[lo] already past: lo
    const int nhi = min(lo + f * step, hi);
    lo += (f - 1) * step + 1;
    hi = nhi;
  }
  return lo;
}

// The last i in [lo, hi] with off[i] <= p, given off[lo] <= p.
__device__ __forceinline__ int last_le(const int32_t* __restrict__ off, int lo, int hi, int p) {
  int n = hi - lo + 1;
  while (n > 1) {
    const int half = n >> 1;
    if (__ldg(off + lo + half) <= p) lo += half;
    n -= half;
  }
  return lo;
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

// The range of B that row `row` searches: its start and length, clamped
// to B and, for padded rows, to their width.
__device__ __forceinline__ void range_of(const Args& a, int row, int64_t& bs, int& bl) {
  const int64_t id = a.rid ? __ldg(a.rid + row) : (int64_t)row * a.rid_step;
  bs = a.rstart ? (int64_t)__ldg(a.rstart + id * a.rstep) : id * a.b_stride;
  bs = min(max(bs, (int64_t)0), a.nB);
  int64_t n = __ldg(a.rlen + id * a.rstep);
  n = min(max(n, (int64_t)0), (int64_t)a.bcap);
  bl = (int)min(n, a.nB - bs);
}

__device__ __forceinline__ int valid_len(const Args& a, int row) {
  return a.LA ? min(max(__ldg(a.LA + row), 0), a.pa) : a.pa;
}

__global__ void __launch_bounds__(kThreads, kMinCtas) setop_rows_single_pass(Args a) {
  extern __shared__ __align__(16) uint32_t sb[];  // all of B, or a tile's window of it
  __shared__ uint32_t bits[kChunks];              // keep bits of each chunk
  __shared__ int chunk_off[kChunks + 1];          // kept before each chunk; the tile's total
  __shared__ int s_tile, s_rs, s_re, s_ilo, s_ihi, s_gex, s_rex, s_bound[2];
  // the tile's rows rs.. (at most kRowCap): ragged, each row's first
  // position; padded, its valid length; and the range of B it searches
  __shared__ int s_pos[kRowCap], s_bs[kRowCap], s_bl[kRowCap];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ragged = a.off != nullptr;
  const bool search = a.op != kCompact;

  // kept words at local positions before q (q <= kTile)
  auto rank = [&](int q) {
    if (q >= kTile) return chunk_off[kChunks];
    return chunk_off[q >> 5] + __popc(bits[q >> 5] & ((1u << (q & 31)) - 1u));
  };

  if (a.whole) stage_words(sb, a.B, (int)a.nB);  // the loop's first sync publishes it

  for (;;) {
    if (tid == 0) s_tile = atomicAdd(a.counters + 1, 1);
    __syncthreads();
    const int t = s_tile;
    if (t >= a.tiles) return;  // the same for every thread
    const int s = t * a.span;
    const int e = min(s + a.span, a.P);

    // the tile's words: chunk c = warp * kPer + k holds positions
    // s + 32 c + lane, one 128-byte line a load
    uint32_t v[kPer];
    uint8_t kp[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = s + (warp * kPer + k) * 32 + lane;
      v[k] = p < e ? __ldg(a.A + p) : 0u;
      kp[k] = (!search && p < e) ? a.keep[p] : 0;
    }

    // rows: rs holds position s, re position e - 1; the tile writes the
    // row boundaries i in [ilo, ihi), those at positions in [s, e), and
    // the last tile also those at P
    if (ragged) {
      if (warp < 4) {
        const int q = warp == 0 ? s : warp == 1 ? e - 1 : warp == 2 ? s : e;
        const int i = warp_bound<int32_t>(a.off, a.m + 1, q, warp < 2);
        if (lane == 0) {
          if (warp == 0) s_rs = i - 1;
          else if (warp == 1) s_re = i - 1;
          else if (warp == 2) s_ilo = i;
          else s_ihi = t == a.tiles - 1 ? a.m + 1 : i;
        }
      }
    } else if (tid == 0) {
      s_rs = s / a.pa;
      s_re = (e - 1) / a.pa;
      s_ilo = (s + a.pa - 1) / a.pa;
      s_ihi = t == a.tiles - 1 ? a.m + 1 : (e + a.pa - 1) / a.pa;
    }
    __syncthreads();
    const int rs = s_rs, re = s_re;
    const int nrows = re - rs + 1;
    const bool staged = nrows <= kRowCap;
    if (staged) {
      for (int r = tid; r < nrows; r += kThreads) {
        s_pos[r] = ragged ? __ldg(a.off + rs + r) : valid_len(a, rs + r);
        if (search) {
          int64_t bs;
          range_of(a, rs + r, bs, s_bl[r]);
          s_bs[r] = (int)bs;  // nB < 2^31
        }
      }
    }
    __syncthreads();

    // where this tile searches
    int mode = search ? kSmemWhole : kNone;
    int wn = 0;
    if (search && !a.whole) {
      if (rs != re) {
        mode = kGlobal;
        if (tid == 0) atomicAdd(a.counters, 1);
      } else {
        int64_t bs;
        int bl;
        range_of(a, rs, bs, bl);
        const int ve = ragged ? e : min(e, rs * a.pa + valid_len(a, rs));
        if (ve <= s) {
          mode = kNone;  // no valid position in the tile
        } else {
          if (warp < 2) {
            const uint32_t q = __ldg(a.A + (warp == 0 ? s : ve - 1));
            const int at = warp_bound<uint32_t>(a.B + bs, bl, q, warp == 1);
            if (lane == 0) s_bound[warp] = at;
          }
          __syncthreads();
          const int lo = s_bound[0];
          wn = max(s_bound[1] - lo, 0);
          if (wn <= kWindowMax) {
            mode = kSmemWindow;
            stage_words(sb, a.B + bs + lo, wn);
          } else {
            mode = kGlobal;
            if (tid == 0) atomicAdd(a.counters, 1);
          }
          __syncthreads();
        }
      }
    }

    // each word's row (the tile's staged rows searched in lockstep), its
    // validity and the range it searches
    int local[kPer], at[kPer], n[kPer];
    bool valid[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = min(s + (warp * kPer + k) * 32 + lane, e - 1);
      local[k] = ragged ? 0 : p / a.pa - rs;
      if (ragged && rs != re && !staged) local[k] = last_le(a.off, rs, re, p) - rs;
    }
    if (ragged && rs != re && staged) {
      // the last r with s_pos[r] <= p: a search for the first word, then
      // each word (32 positions on) walks on from the word before
      const int p0 = min(s + warp * kPer * 32 + lane, e - 1);
      for (int m = nrows; m > 1;) {
        const int half = m >> 1;
        if (s_pos[local[0] + half] <= p0) local[0] += half;
        m -= half;
      }
#pragma unroll
      for (int k = 1; k < kPer; ++k) {
        const int p = min(s + (warp * kPer + k) * 32 + lane, e - 1);
        int r = local[k - 1];
        while (r + 1 < nrows && s_pos[r + 1] <= p) ++r;
        local[k] = r;
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = s + (warp * kPer + k) * 32 + lane;
      const int row = rs + local[k];
      valid[k] = p < e;
      if (!ragged && valid[k])
        valid[k] = p - row * a.pa < (staged ? s_pos[local[k]] : valid_len(a, row));
      at[k] = n[k] = 0;
      if (search && valid[k] && mode != kNone) {
        if (mode == kSmemWindow) {
          n[k] = wn;
        } else if (staged) {
          at[k] = s_bs[local[k]];
          n[k] = s_bl[local[k]];
        } else {
          int64_t bs;
          range_of(a, row, bs, n[k]);
          at[k] = (int)bs;
        }
      }
    }
    // keep bits, one ballot a chunk
    unsigned hits = 0;
    if (mode == kGlobal) {
      hits = member_all<true>(a.B, at, n, v);
    } else if (search && mode != kNone) {
      hits = member_all<false>(sb, at, n, v);
    }
    uint32_t ball[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool hit = (hits >> k) & 1u;
      const bool kept = valid[k] && (search ? a.op == kIntersect ? hit : !hit : kp[k] != 0);
      ball[k] = __ballot_sync(kFull, kept);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) bits[warp * kPer + k] = ball[k];
    }
    __syncthreads();

    // places within the tile, then the look-back for the tile's prefix
    if (warp == 0) {
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
      chunk_off[lane] = i0 - x0;
      chunk_off[lane + 32] = half + i1 - x1;
      if (lane == 31) chunk_off[kChunks] = half + i1;
      __syncwarp();
      const int total = chunk_off[kChunks];
      // the count since the last row start, for the padded places: reset
      // where the row of position e - 1 starts inside the tile
      const int last_start = ragged ? __ldg(a.off + re) : re * a.pa;
      const bool seg = last_start >= s;
      const int agg_r = seg ? total - rank(last_start - s) : total;
      int gex = 0, rex = 0;
      if (a.aligned) {
        // whole rows: every place is the row's own, nothing to look back on
      } else if (t == 0) {
        if (lane == 0) store_release(a.status, pack(kPrefix, agg_r, total));
      } else {
        if (lane == 0) store_release(a.status + t, pack(seg ? kAggSeg : kAgg, agg_r, total));
        // the warp reads 32 predecessors at once, lane i tile j - i, and
        // combines them from the nearest to the nearest inclusive prefix;
        // acc: tiles j + 1 .. t - 1 combined, earlier on the left
        int acc_g = 0, acc_r = 0;
        bool acc_seg = false;
        for (int j = t - 1;; j -= 32) {
          unsigned long long w = pack(kPrefix, 0, 0);  // before tile 0: never combined
          if (j - lane >= 0) {
            while (((w = load_acquire(a.status + j - lane)) >> 62) == 0) {
            }
          }
          const unsigned found = __ballot_sync(kFull, (w >> 62) == kPrefix);
          const int stop = found ? __ffs(found) - 1 : 32;
          for (int i = 0; i < stop; ++i) {
            const unsigned long long wi = __shfl_sync(kFull, w, i);
            acc_r = acc_seg ? acc_r : (int)((wi >> 31) & kMask31) + acc_r;
            acc_g += (int)(wi & kMask31);
            acc_seg = acc_seg || (wi >> 62) == kAggSeg;
          }
          if (stop < 32) {
            const unsigned long long wp = __shfl_sync(kFull, w, stop);
            gex = (int)(wp & kMask31) + acc_g;
            rex = acc_seg ? acc_r : (int)((wp >> 31) & kMask31) + acc_r;
            break;
          }
        }
        if (lane == 0) store_release(a.status + t, pack(kPrefix, seg ? agg_r : rex + agg_r, gex + total));
      }
      if (lane == 0) {
        s_gex = gex;
        s_rex = rex;
      }
    }
    __syncthreads();
    const int gex = s_gex, rex = s_rex;

    // the kept words at their places
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if ((ball[k] >> lane) & 1u) {
        const int c = warp * kPer + k;
        const int rk = chunk_off[c] + __popc(ball[k] & ((1u << lane) - 1u));
        int at = gex + rk;
        if (!ragged) {  // padded: at the row's base plus the count since its start
          const int p = s + c * 32 + lane;
          const int start = p / a.pa * a.pa;
          at = start + (start >= s ? rk - rank(start - s) : rex + rk);
        }
        a.out[at] = v[k];
      }
    }
    // the row boundaries this tile holds: out_off, and padded, cnt; with
    // whole rows, their counts alone
    for (int r = rs + tid; a.aligned && r <= re; r += kThreads)
      a.cnt[r] = rank(min((r + 1) * a.pa, e) - s) - rank(r * a.pa - s);
    for (int i = s_ilo + tid; !a.aligned && i < s_ihi; i += kThreads) {
      const int pos = ragged ? __ldg(a.off + i) : i * a.pa;
      const int g = gex + rank(pos - s);
      a.out_off[i] = g;
      if (a.cnt != nullptr && i > 0) {
        const int prev = ragged ? __ldg(a.off + i - 1) : (i - 1) * a.pa;
        a.cnt[i - 1] = g - (prev >= s ? gex + rank(prev - s) : gex - rex);
      }
    }
    __syncthreads();  // before the next tile reuses the shared state
  }
}

int set_attribute(int device) {
  static int done[kMaxDevices];
  if (device >= 0 && device < kMaxDevices && done[device]) return 0;
  const int err = (int)cudaFuncSetAttribute(
      setop_rows_single_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, kWholeMax * 4);
  if (!err && device >= 0 && device < kMaxDevices) done[device] = 1;
  return err;
}

}  // namespace

extern "C" {

int setop_rows_tile() { return kTile; }

// One call. buf (int32 words, 8-byte aligned) holds, in this order: the
// status words (2 a tile), out_off (m + 1), the counters (2), then cnt
// (m, padded only) and out (P words); the call zeroes the first three and,
// padded, fills out with UINT32_MAX, on `stream`, then launches the
// kernel. off null: padded rows of pa with lengths LA (null: all valid).
// rid null: range id row * rid_step; rstart null: range start id *
// b_stride; range lengths rlen[id * rstep], clamped to bcap. op 0
// intersect, 1 difference, 2 compaction of keep. Returns 0 or the
// cudaError_t of the first call that failed.
int setop_rows_launch(const int32_t* A, const int32_t* off, const int32_t* LA,
                      const uint8_t* keep, const int32_t* B, int64_t nB, const int32_t* rid,
                      int rid_step, const int32_t* rstart, int64_t b_stride,
                      const int32_t* rlen, int rstep, int bcap, int m, int pa, int P, int op,
                      int32_t* buf, int device, cudaStream_t stream) {
  if (op < kIntersect || op > kCompact || P <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const bool search = op != kCompact;
  Args a{};
  a.A = reinterpret_cast<const uint32_t*>(A);
  a.off = off;
  a.LA = LA;
  a.keep = keep;
  a.B = reinterpret_cast<const uint32_t*>(B);
  a.rid = rid;
  a.rstart = rstart;
  a.rlen = rlen;
  a.nB = search ? nB : 0;
  a.b_stride = b_stride;
  a.m = m;
  a.pa = pa;
  a.P = P;
  // padded rows of at most a tile: tiles of whole rows (more tiles, none of
  // which needs a status word: the buffer holds ceil(P / kTile) of them)
  const int64_t layout_tiles = ((int64_t)P + kTile - 1) / kTile;
  a.aligned = !off && pa <= kTile;
  a.span = a.aligned ? kTile / pa * pa : kTile;
  a.tiles = (int)(((int64_t)P + a.span - 1) / a.span);
  a.rid_step = rid_step;
  a.rstep = rstep;
  a.bcap = bcap;
  a.op = op;
  a.whole = search && nB <= kWholeMax && nB <= 2 * (int64_t)P + 4096;
  a.status = reinterpret_cast<unsigned long long*>(buf);
  a.out_off = buf + 2 * layout_tiles;
  a.counters = a.out_off + m + 1;
  a.cnt = off ? nullptr : a.counters + 2;
  a.out = reinterpret_cast<uint32_t*>(a.counters + 2 + (off ? 0 : m));
  const size_t dyn = !search ? 0 : a.whole ? (size_t)(nB > 0 ? nB : 1) * 4 : (size_t)kWindowMax * 4;

  int cur = -1;
  int err = (int)cudaGetDevice(&cur);
  if (!err && cur != device) err = (int)cudaSetDevice(device);
  if (!err) err = set_attribute(device);
  if (!err) {
    const size_t zero = (size_t)(2 * layout_tiles + m + 1 + 2) * 4;
    err = (int)cudaMemsetAsync(buf, 0, zero, stream);
  }
  if (!err && !off) err = (int)cudaMemsetAsync(a.out, 0xFF, (size_t)P * 4, stream);
  int per_sm = 0, sms = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, setop_rows_single_pass,
                                                             kThreads, dyn);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (!err) {
    const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    const unsigned grid = (unsigned)(a.tiles < resident ? a.tiles : resident);
    setop_rows_single_pass<<<grid, kThreads, dyn, stream>>>(a);
    err = (int)cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return err;
}

}  // extern "C"
