// setop_merge (K4, K5, K6) for Hopper: the union of sorted lists taken
// in pairs, and the k-way intersection, each with its stable compaction,
// in one single-pass kernel a call (a k-way merge is rounds of the pair
// union).
//
// Replaces, in the JAX package, the XLA programs of
// dgraph_tpu/ops/setops.py: union (:102, K4), merge_sorted (:121, K5) and
// intersect_many (:141, K6), as dgraph_tpu/query/dispatch.py runs them:
// union vmapped over pow2 buckets of segment pairs (_run_bucket), and the
// k lists of a one-segment AND or OR chain padded to (k, pow2)
// (run_chain, _get_jitted_chain).
//
// What it computes.
//   - setop_union_pairs: X holds n sorted lists back to back, list i at
//     [lo[i], lo[i + 1]) (lo[0] = 0). Job j is the union of lists 2j and
//     2j + 1 (an empty list when 2j + 1 = n): every value of either list
//     once, ascending. The kept words come out back to back, job j's at
//     [out_off[j], out_off[j + 1]), so the result is again n' = ceil(n /
//     2) lists in the input's layout: a k-way merge (K5) is
//     ceil(log2 k) rounds over the card's own output, each round's total
//     read by the kernel from lo[n], with no copy to the host between
//     rounds. The union of a and b is the dispatcher's ragged batch with
//     a_i and b_i as lists 2i and 2i + 1 (K4).
//   - setop_intersect_many: X holds k lists, list 0 at [lo[0], lo[1]).
//     Each word of list 0 that every other list holds is kept, in list
//     0's order and with list 0's duplicates (the reference's count form:
//     a word survives where its membership count reaches k - 1).
// Uids are the bits of int32, compared unsigned; lists are sorted
// ascending as uint32 (the reference's precondition). The lists are
// ragged: a word is valid because its index lies inside its list, never
// by its value, so 0xFFFFFFFF is a legal uid and no padding is read.
//
// What bounds it. Bytes: every valid word read once, the kept words and
// the offsets written once. A union word costs a merge-path search (about
// log2 of the shorter list's length in loads, a thread) and a compare; an
// intersect word log2 of a list's window a list.
//
// Design. Tiles of 2048 positions, taken from a ticket counter by
// resident CTAs (not blockIdx), so a tile waits only on tiles that
// running CTAs hold, and each tile's place in the output comes from a
// decoupled look-back over its predecessors' status words (one 64-bit
// word a tile: a state in 2 bits, the count before it in the rest), as
// in setop_rows.cu, whose search, staging and scan it shares
// (setop_common.cuh). The status words, the ticket and the offsets belong
// to the call: the launch zeroes them on the call's stream.
//   - Union: a tile is 2048 merged positions (the merged sequence of job j
//     occupies [lo[2j], lo[2j + 2]), the positions its two lists hold).
//     Thread i takes 8 of them in a row: it finds its job among the
//     tile's (a binary search over the job starts), its split of the
//     job's two lists by a merge-path search, then merges 8 words,
//     keeping a word unless it equals the word merged before it (at its
//     first position: the larger of the last words before the split).
//     A block scan of the kept counts places them in the tile.
//   - Intersect: a tile is 2048 words of list 0, one 128-byte line a
//     warp's load. For each other list, the window between the tile's
//     first and last word is staged in shared memory with cp.async when
//     it fits (8K words), else searched in global memory; a lane's 8
//     searches run in lockstep; the tile stops at the first list that
//     leaves it no word. Ballots and a scan over 64 chunks place the
//     kept words.
// No sort, cumsum or nonzero runs in it.

#include "setop_common.cuh"

namespace {

// the counts of a status word (the state in bits 62-63)
constexpr unsigned long long kCount = (1ull << 62) - 1;

// The first i in [lo, hi) with key(i) > q, hi if none; one thread.
template <typename Key>
__device__ __forceinline__ int upper_in(Key key, int lo, int hi, long long q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (key(mid) > q) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// The tile's place in the output: its aggregate published, then the
// counts of its predecessors read 32 at a time (acquire) back to the
// nearest inclusive prefix, its own prefix published (release). Warp 0
// alone calls it; every lane returns the count before the tile.
__device__ int look_back(unsigned long long* status, int t, int total) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) store_release(status, (kPrefix << 62) | (unsigned long long)total);
    return 0;
  }
  if (lane == 0) store_release(status + t, (kAgg << 62) | (unsigned long long)total);
  long long acc = 0;
  int before = 0;
  for (int j = t - 1;; j -= 32) {
    unsigned long long w = kPrefix << 62;  // before tile 0: a prefix of 0
    if (j - lane >= 0) {
      while (((w = load_acquire(status + j - lane)) >> 62) == 0) {
      }
    }
    const unsigned found = __ballot_sync(kFull, (w >> 62) == kPrefix);
    const int stop = found ? __ffs(found) - 1 : 32;
    long long mine = lane < stop ? (long long)(w & kCount) : 0;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) mine += __shfl_xor_sync(kFull, mine, d);
    acc += mine;
    if (stop < 32) {
      before = (int)((long long)(__shfl_sync(kFull, w, stop) & kCount) + acc);
      break;
    }
  }
  if (lane == 0) store_release(status + t, (kPrefix << 62) | (unsigned long long)(before + total));
  return before;
}

// ---------------------------------------------------------------------------
// Union of lists 2j and 2j + 1, every job of a call
// ---------------------------------------------------------------------------

struct UnionArgs {
  const uint32_t* X;
  const int32_t* lo;  // n + 1 list offsets, lo[0] = 0; lo[n] = the words of X
  int n, jobs;        // lists; jobs = ceil(n / 2)
  uint32_t* out;
  int32_t* out_off;   // jobs + 1
  unsigned long long* status;  // one word a tile, zeroed
  int32_t* ticket;    // zeroed
};

// list boundary i, lists past n empty
__device__ __forceinline__ int bound_at(const UnionArgs& a, int i) {
  return __ldg(a.lo + min(i, a.n));
}

__global__ void __launch_bounds__(kThreads, kMinCtas) setop_union_pairs(UnionArgs a) {
  __shared__ int s_tile, s_j0, s_j1, s_ilo, s_ihi, s_gex;
  __shared__ int s_before[kThreads];     // kept words before each thread's positions
  __shared__ unsigned s_bits[kThreads];  // each thread's keep bits
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = bound_at(a, a.n);  // this round's words: read on the card
  const int tiles = (P + kTile - 1) / kTile;
  auto start = [&](int j) { return bound_at(a, 2 * j); };  // job j's first position

  for (;;) {
    if (tid == 0) s_tile = atomicAdd(a.ticket, 1);
    __syncthreads();
    const int t = s_tile;
    if (t >= tiles) return;  // the same for every thread
    const int d = t * kTile;
    const int e = min(d + kTile, P);

    // the jobs that hold positions d and e - 1, and the job boundaries
    // this tile writes: those at positions in [d, e), the last tile also
    // those at P
    if (warp < 4) {
      const int q = warp == 0 ? d : warp == 1 ? e - 1 : warp == 2 ? d : e;
      const int i = warp_search(start, a.jobs + 1, q, warp < 2);
      if (lane == 0) {
        if (warp == 0) s_j0 = i - 1;
        else if (warp == 1) s_j1 = i - 1;
        else if (warp == 2) s_ilo = i;
        else s_ihi = t == tiles - 1 ? a.jobs + 1 : i;
      }
    }
    __syncthreads();

    // this thread's positions [p0, p1): their words and keep bits
    const int p0 = d + tid * kPer;
    const int p1 = min(p0 + kPer, e);
    uint32_t v[kPer];
    unsigned bits = 0;
    if (p0 < e) {
      int j = upper_in(start, s_j0 + 1, s_j1 + 1, p0) - 1;  // the job that holds p0
      int as = bound_at(a, 2 * j), am = bound_at(a, 2 * j + 1), ae = bound_at(a, 2 * j + 2);
      const uint32_t* A = a.X + as;
      const uint32_t* B = a.X + am;
      int la = am - as, lb = ae - am;
      // merge path: i words of A and k of B come before merged position
      // p0 - as, A's first on equal words
      const int diag = p0 - as;
      int lo = max(0, diag - lb), hi = min(diag, la);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(A + mid) <= __ldg(B + diag - 1 - mid)) lo = mid + 1;
        else hi = mid;
      }
      int i = lo, k = diag - lo;
      bool has_prev = diag > 0;  // the word merged before p0, in this job
      uint32_t prev = 0;
      if (i > 0) prev = __ldg(A + i - 1);
      if (k > 0) prev = max(prev, __ldg(B + k - 1));
#pragma unroll
      for (int x = 0; x < kPer; ++x) {
        const int p = p0 + x;
        if (p >= p1) break;
        if (p >= ae) {  // the next job with a word starts at p
          j = upper_in(start, j + 1, s_j1 + 1, p) - 1;
          as = bound_at(a, 2 * j);
          am = bound_at(a, 2 * j + 1);
          ae = bound_at(a, 2 * j + 2);
          A = a.X + as;
          B = a.X + am;
          la = am - as;
          lb = ae - am;
          i = k = 0;
          has_prev = false;
        }
        const bool take_a = i < la && (k >= lb || __ldg(A + i) <= __ldg(B + k));
        const uint32_t w = take_a ? __ldg(A + i++) : __ldg(B + k++);
        if (!has_prev || w != prev) bits |= 1u << x;
        v[x] = w;
        prev = w;
        has_prev = true;
      }
    }

    // places within the tile: a block scan of the threads' kept counts
    const int c = __popc(bits);
    int incl = c;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before_warp = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before_warp += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    s_before[tid] = before_warp + incl - c;
    s_bits[tid] = bits;
    if (warp == 0) {
      const int gex = look_back(a.status, t, total);
      if (lane == 0) s_gex = gex;
    }
    __syncthreads();
    const int gex = s_gex;

    // kept words before local position q (q <= kTile)
    auto rank = [&](int q) {
      if (q >= kTile) return total;
      const int th = q / kPer;
      return s_before[th] + __popc(s_bits[th] & ((1u << (q % kPer)) - 1u));
    };
    const int mine = gex + s_before[tid];
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      if ((bits >> x) & 1u) a.out[mine + __popc(bits & ((1u << x) - 1u))] = v[x];
    }
    for (int i = s_ilo + tid; i < s_ihi; i += kThreads)
      a.out_off[i] = gex + rank((int)start(i) - d);
    __syncthreads();  // before the next tile reuses the shared state
  }
}

// ---------------------------------------------------------------------------
// The k-way intersection of list 0 with lists 1 .. k - 1
// ---------------------------------------------------------------------------

struct ManyArgs {
  const uint32_t* X;
  const int32_t* lo;  // k + 1 list offsets
  int k;
  uint32_t* out;
  int32_t* head;      // [1] the kept count (head[0] stays 0); zeroed
  unsigned long long* status;  // one word a tile, zeroed
  int32_t* ticket;    // zeroed
};

__global__ void __launch_bounds__(kThreads, kMinCtas) setop_intersect_many(ManyArgs a) {
  extern __shared__ __align__(16) uint32_t sw[];  // a list's window
  __shared__ uint32_t bits[kChunks];              // keep bits of each chunk
  __shared__ int chunk_off[kChunks + 1];          // kept before each chunk; the tile's total
  __shared__ int s_tile, s_bound[2], s_gex;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base0 = __ldg(a.lo);
  const int P = __ldg(a.lo + 1) - base0;  // the words of list 0
  const int tiles = (P + kTile - 1) / kTile;
  const uint32_t* A = a.X + base0;

  for (;;) {
    if (tid == 0) s_tile = atomicAdd(a.ticket, 1);
    __syncthreads();
    const int t = s_tile;
    if (t >= tiles) return;  // the same for every thread
    const int s = t * kTile;
    const int e = min(s + kTile, P);

    // the tile's words: chunk c = warp * kPer + x holds positions
    // s + 32 c + lane, one 128-byte line a load
    uint32_t v[kPer];
    unsigned alive = 0;
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int p = s + (warp * kPer + x) * 32 + lane;
      v[x] = p < e ? __ldg(A + p) : 0u;
      alive |= p < e ? 1u << x : 0u;
    }
    const uint32_t first = __ldg(A + s), last = __ldg(A + e - 1);
    for (int l = 1; l < a.k; ++l) {
      if (!__syncthreads_or(alive != 0)) break;  // no word of the tile left
      const int ls = __ldg(a.lo + l);
      const int ln = max(__ldg(a.lo + l + 1) - ls, 0);
      const uint32_t* L = a.X + ls;
      // the window of list l between the tile's first and last word
      if (warp < 2) {
        const int at = warp_search([&](int i) { return __ldg(L + i); }, ln,
                                   warp == 0 ? first : last, warp == 1);
        if (lane == 0) s_bound[warp] = at;
      }
      __syncthreads();
      const int wlo = s_bound[0];
      const int wn = max(s_bound[1] - wlo, 0);
      const bool staged = wn <= kWindowMax;
      if (staged) stage_words(sw, L + wlo, wn);
      __syncthreads();
      int at[kPer], n[kPer];
#pragma unroll
      for (int x = 0; x < kPer; ++x) {
        at[x] = staged ? 0 : wlo;
        n[x] = (alive >> x) & 1u ? wn : 0;
      }
      alive &= staged ? member_all<false>(sw, at, n, v) : member_all<true>(L, at, n, v);
      __syncthreads();  // before the next list's window overwrites this one
    }

    // keep bits, one ballot a chunk; places within the tile
    uint32_t ball[kPer];
#pragma unroll
    for (int x = 0; x < kPer; ++x) ball[x] = __ballot_sync(kFull, (alive >> x) & 1u);
    if (lane == 0) {
#pragma unroll
      for (int x = 0; x < kPer; ++x) bits[warp * kPer + x] = ball[x];
    }
    __syncthreads();
    if (warp == 0) {
      const int total = chunk_scan(bits, chunk_off);
      const int gex = look_back(a.status, t, total);
      if (lane == 0) {
        s_gex = gex;
        if (t == tiles - 1) a.head[1] = gex + total;
      }
    }
    __syncthreads();
    const int gex = s_gex;
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      if ((ball[x] >> lane) & 1u) {
        const int c = warp * kPer + x;
        a.out[gex + chunk_off[c] + __popc(ball[x] & ((1u << lane) - 1u))] = v[x];
      }
    }
    __syncthreads();  // before the next tile reuses the shared state
  }
}

// Switch to `device`, zero `zero_words` words of buf on `stream`, and
// find how many CTAs of `kernel` the card holds at once.
template <typename Kernel>
int prepare(Kernel kernel, size_t dyn, int device, int32_t* buf, size_t zero_words,
            cudaStream_t stream, int& cur, int64_t& resident) {
  cur = -1;
  int err = (int)cudaGetDevice(&cur);
  if (!err && cur != device) err = (int)cudaSetDevice(device);
  if (!err) err = (int)cudaMemsetAsync(buf, 0, zero_words * 4, stream);
  int per_sm = 0, sms = 0;
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, dyn);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  resident = (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  return err;
}

}  // namespace

extern "C" {

int setop_merge_tile() { return kTile; }

// One round of the pair union. X holds n lists (offsets lo, n + 1 of
// them, lo[0] = 0), at most cap words in all. buf (int32 words, 8-byte
// aligned) holds, in this order: the status words (2 a tile of cap),
// out_off (ceil(n / 2) + 1), the ticket (1), then out (cap words); the
// call zeroes the first three on `stream`, then launches the kernel.
// Returns 0 or the cudaError_t of the first call that failed.
int setop_union_launch(const int32_t* X, const int32_t* lo, int n, int cap, int32_t* buf,
                       int device, cudaStream_t stream) {
  if (n <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles = ((int64_t)cap + kTile - 1) / kTile;
  UnionArgs a{};
  a.X = reinterpret_cast<const uint32_t*>(X);
  a.lo = lo;
  a.n = n;
  a.jobs = (n + 1) / 2;
  a.status = reinterpret_cast<unsigned long long*>(buf);
  a.out_off = buf + 2 * tiles;
  a.ticket = a.out_off + a.jobs + 1;
  a.out = reinterpret_cast<uint32_t*>(a.ticket + 1);
  int cur;
  int64_t resident;
  int err = prepare(setop_union_pairs, 0, device, buf, (size_t)(2 * tiles + a.jobs + 1 + 1),
                    stream, cur, resident);
  if (!err && tiles > 0) {
    const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
    setop_union_pairs<<<grid, kThreads, 0, stream>>>(a);
    err = (int)cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return err;
}

// The k-way intersection. X holds k lists (offsets lo, k + 1 of them), at
// most cap words in all. buf holds: the status words (2 a tile of cap),
// head (2: 0 and the kept count), the ticket (1), then out (cap words);
// the call zeroes the first three on `stream`, then launches the kernel.
int setop_intersect_many_launch(const int32_t* X, const int32_t* lo, int k, int cap,
                                int32_t* buf, int device, cudaStream_t stream) {
  if (k <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles = ((int64_t)cap + kTile - 1) / kTile;
  ManyArgs a{};
  a.X = reinterpret_cast<const uint32_t*>(X);
  a.lo = lo;
  a.k = k;
  a.status = reinterpret_cast<unsigned long long*>(buf);
  a.head = buf + 2 * tiles;
  a.ticket = a.head + 2;
  a.out = reinterpret_cast<uint32_t*>(a.ticket + 1);
  const size_t dyn = (size_t)kWindowMax * 4;
  int cur;
  int64_t resident;
  int err = prepare(setop_intersect_many, dyn, device, buf, (size_t)(2 * tiles + 3), stream, cur,
                    resident);
  if (!err && tiles > 0) {
    const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
    setop_intersect_many<<<grid, kThreads, dyn, stream>>>(a);
    err = (int)cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return err;
}

}  // extern "C"
