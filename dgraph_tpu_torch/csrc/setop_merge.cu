// setop_merge (K4, K5, K6) for Hopper: the union of sorted lists taken
// in pairs, the k-way merge, and the k-way intersection, each with its
// stable compaction, each in one single-pass launch a call.
//
// Replaces, in the JAX package, the XLA programs of
// dgraph_tpu/ops/setops.py: union (:102, K4), merge_sorted (:121, K5) and
// intersect_many (:141, K6), as dgraph_tpu/query/dispatch.py runs them:
// union vmapped over pow2 buckets of segment pairs (_run_bucket), and the
// k lists of a one-segment AND or OR chain padded to (k, pow2)
// (run_chain, _get_jitted_chain).
//
// What it computes.
//   - setop_union_pairs (K4): X holds n sorted lists back to back, list i
//     at [lo[i], lo[i + 1]) (lo[0] = 0). Job j is the union of lists 2j
//     and 2j + 1 (an empty list when 2j + 1 = n): every value of either
//     list once, ascending. The kept words come out back to back, job j's
//     at [out_off[j], out_off[j + 1]), so the result is again n' = ceil(n
//     / 2) lists in the input's layout. The union of a and b is the
//     dispatcher's ragged batch with a_i and b_i as lists 2i and 2i + 1.
//   - setop_merge_rounds (K5): the k-way merge, ceil(log2 k) rounds of
//     the pair union (at least one: a single list is deduplicated too),
//     each over the previous round's output, all in one cooperative
//     launch. Round r writes scratch buffer r % 2; round 0 reads X and
//     never writes it; each round reads its total from the previous
//     round's last offset, on the card.
//   - setop_intersect_many (K6): X holds k lists, list 0 at [lo[0],
//     lo[1]). Each word of list 0 that every other list holds is kept, in
//     list 0's order and with list 0's duplicates (the reference's count
//     form: a word survives where its membership count reaches k - 1).
// Uids are the bits of int32, compared unsigned; lists are sorted
// ascending as uint32 (the reference's precondition). The lists are
// ragged: a word is valid because its index lies inside its list, never
// by its value, so 0xFFFFFFFF is a legal uid and no padding is read.
//
// What bounds it. Bytes: every valid word read once, the kept words and
// the offsets written once; for the intersection, of lists 1 .. k - 1,
// only the 32-byte sectors a membership of list 0's words needs. A union
// word costs a merge-path search (about log2 of its job's words in the
// tile, in shared memory, a thread) and a compare; an intersect word
// about log2 of a list's window a list. Below the bytes, a tile's latency:
// the chain of dependent loads before its words are staged or searched,
// and its look-back.
//
// Design. Tiles of 2048 positions, each a CTA's at a time, and each
// tile's place in the output from a decoupled look-back over its
// predecessors' status words (one 64-bit word a tile: a state in 2 bits,
// the count before it in the rest), as in setop_rows.cu, whose tile
// shape, warp search, staging and scan it shares (setop_common.cuh). The status
// words, the ticket and the offsets belong to the call: the launch zeroes
// them on the call's stream. A status word carries its counts and
// nothing else, and no tile reads another's kept words inside a launch,
// so the look-back (one for all three kernels) reads and writes them
// relaxed (a release orders, so waits for, the CTA's earlier stores), 256
// predecessors a step, the whole CTA at once.
//   - Union: a tile is the merged positions [d, e), e - d <= 2048 (the
//     merged sequence of job j occupies [lo[2j], lo[2j + 2]), the
//     positions its two lists hold), so it needs exactly e - d input words,
//     from at most five contiguous ranges of X: the A and B parts of the
//     job j0 that holds d, the whole jobs after it (where a position is
//     its own word's index in X), and the A and B parts of the job j1 that
//     holds e - 1. One warp a boundary finds j0 and j1 and the merge-path
//     splits at d and at e (32 probes a round, so about log32 dependent
//     loads, once a tile), a third the first job that starts at d. The
//     CTA then stages the tile's words in shared memory by merged
//     position (a job's A part, then its B part), with coalesced loads,
//     and the list offsets of its jobs when they fit (2 x 2048 + 8 of
//     them; a tile of more, empty, jobs reads them from global memory),
//     and the word merged just before d, the dedupe's `prev` there.
//     Thread i takes positions d + 8i .. d + 8i + 7: it finds its job and
//     its merge-path split in shared memory, then merges 8 words, keeping
//     a word unless it equals the word merged before it in its job (a's
//     word first on ties). A block scan ranks the kept words; they go to
//     shared memory at their rank, and the tile writes them out as one
//     contiguous block at its look-back offset. The union kernel takes
//     tiles from a ticket counter, so a tile waits only on tiles that
//     running CTAs hold, whatever else shares the card.
//   - K5: the rounds kernel is launched with cudaLaunchCooperativeKernel,
//     so its grid (at most the CTAs the card holds at once) is resident as
//     a whole. Each CTA takes tiles blockIdx.x, + gridDim.x, ... of a
//     round (its predecessors' CTAs all run, so the look-back cannot
//     wait forever), then waits at a grid-wide barrier (a counter raised
//     once a CTA a round, after a fence) before the next round. Each round
//     has its own status words; one memset zeroes every round's, the
//     barrier and both offset buffers. Inside one launch the L1 cache is
//     not coherent across SMs, and from round 1 on, a round's inputs were
//     written earlier in the same launch (and, with ping-pong buffers, an
//     SM may still hold lines of them from two rounds back), so every
//     read of words and offsets in the union goes through L2 (__ldcg).
//   - Intersect: a tile is 2048 words of list 0, one 128-byte line a
//     warp's load, taken from a ticket counter. A list's window is the
//     part of it between the tile's first and last word; its bounds
//     depend on those two words alone, so the tile finds the windows of
//     four lists at once (two warps a list, a 32-probe search each, about
//     log32 of the list's length dependent loads), before it searches the
//     first of them: at k <= 5, one chain of bound searches a tile. Then,
//     list by list, the CTA stages in shared memory with cp.async, every
//     load in flight at once, the window whole when it fits (8K words),
//     else a sample of it: every s-th word, s = ceil(wn / 8K), so at most
//     8K words. A lane's 8 words search in lockstep: in the staged window
//     (member_all), or first in the sample (<= 13 steps in shared memory)
//     and then only in the bracket of s words after the sample word found
//     (ceil(log2 s) dependent loads in global memory, one or two lines for
//     windows up to 256K words); a word below the sample's first is
//     absent and reads nothing more. No binary search over a whole window
//     runs in global memory. The tile stops at the first list that leaves
//     it no word, and finds no more windows. Ballots and a scan over 64
//     chunks place the kept words.
// The host side caches the CTAs a card holds at once, per device and
// kernel: a call is one memset and one launch. No sort, cumsum or nonzero
// runs in it.

#include <atomic>

#include "setop_common.cuh"

namespace {

// the counts of a status word (the state in bits 62-63)
constexpr unsigned long long kCount = (1ull << 62) - 1;
// list offsets a union tile stages: those of 2048 one-word jobs and more
constexpr int kLoCap = 2 * kTile + 8;
// lists whose windows an intersect tile finds in one round: two warps a list
constexpr int kBatch = kWarps / 2;

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

// Strong loads and stores at the card's scope with no ordering of other
// memory: a tile's status word carries its counts and nothing else, so a
// look-back needs no acquire or release (the fences of a
// release wait for the previous tile's stores of kept words).
__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int load_relaxed_i32(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The tile's place in the output, every thread of the CTA calling it: its
// aggregate published, then its predecessors' status words read 256 a
// step (relaxed), the nearest inclusive prefix among them found by
// ballots, the counts after it summed by a block reduction, its own
// prefix published. `first` and `sums` are kWarps words of shared
// scratch. Returns the count before the tile to every thread.
__device__ int look_back_block(unsigned long long* status, int t, int total, int* first,
                               long long* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (t == 0) {
    if (tid == 0) store_relaxed(status, (kPrefix << 62) | (unsigned long long)total);
    return 0;
  }
  if (tid == 0) store_relaxed(status + t, (kAgg << 62) | (unsigned long long)total);
  long long acc = 0;
  for (int j = t - 1;; j -= kThreads) {
    unsigned long long w = kPrefix << 62;  // before tile 0: a prefix of 0
    if (j - tid >= 0) {
      while (((w = load_relaxed(status + j - tid)) >> 62) == 0) {
      }
    }
    const unsigned found = __ballot_sync(kFull, (w >> 62) == kPrefix);
    if (lane == 0) first[warp] = found ? warp * 32 + __ffs(found) - 1 : kThreads;
    __syncthreads();
    int stop = kThreads;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) stop = min(stop, first[x]);
    long long mine = tid <= stop ? (long long)(w & kCount) : 0;  // the prefix's own count too
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) mine += __shfl_xor_sync(kFull, mine, d);
    if (lane == 0) sums[warp] = mine;
    __syncthreads();
#pragma unroll
    for (int x = 0; x < kWarps; ++x) acc += sums[x];
    __syncthreads();  // before the next step reuses first and sums
    if (stop < kThreads) break;
  }
  if (tid == 0) store_relaxed(status + t, (kPrefix << 62) | (unsigned long long)(acc + total));
  return (int)acc;
}

// ---------------------------------------------------------------------------
// Union of lists 2j and 2j + 1, every job of a round
// ---------------------------------------------------------------------------

struct UnionArgs {
  const uint32_t* X;
  const int32_t* lo;  // n + 1 list offsets, lo[0] = 0; lo[n] = the words of X
  int n, jobs;        // lists; jobs = ceil(n / 2)
  uint32_t* out;
  int32_t* out_off;   // jobs + 1
  unsigned long long* status;  // one word a tile, zeroed
  int32_t* ticket;    // zeroed (the ticketed kernel only)
};

struct UnionShared {
  uint32_t words[kTile];  // the tile's input words by merged position, then its kept words
  int32_t lo[kLoCap];     // lo[2 jlo ..], when they fit
  int before[kThreads];   // kept words before each thread's positions
  unsigned bits[kThreads];  // each thread's keep bits
  int warp_sum[kWarps];
  int first[kWarps];      // the look-back's scratch
  long long sums[kWarps];
  int tile, ilo;
  int j0, s0, m0, e0, ia, ka;  // the job that holds d, its lists, its split at d
  int j1, s1, m1, ic, kc;      // the job that holds e - 1, its lists, its split at e
  uint32_t prev;               // the word merged just before d, when j0 starts before d
};

// The positions [t * kTile, ..) of a round of P positions (tiles of them).
__device__ __forceinline__ void union_tile(const UnionArgs& a, UnionShared& sm, int t, int P,
                                           int tiles) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t* X = a.X;
  const int d = t * kTile;
  const int e = d + min(kTile, P - d);
  // list boundary i through L2 (lists past n empty)
  auto glo = [&](int i) { return __ldcg(a.lo + min(i, a.n)); };

  // the jobs that hold positions d and e - 1 and their merge-path splits
  // at d and e (i words of A and diag - i of B come before merged
  // position diag of a job, A's first on equal words); the first job that
  // starts at d or later
  if (warp < 3) {
    const int q = warp == 0 ? d : e - 1;
    if (warp == 2) {
      const int i = warp_first([&](int j) { return glo(2 * j) >= d; }, 0, a.jobs + 1);
      if (lane == 0) sm.ilo = i;
    } else {
      const int j = warp_first([&](int j) { return glo(2 * j) > q; }, 0, a.jobs + 1) - 1;
      const int s = glo(2 * j), m = glo(2 * j + 1), en = glo(2 * j + 2);
      const int diag = (warp == 0 ? d : e) - s;
      const int i = warp_first(
          [&](int i) { return __ldcg(X + s + i) > __ldcg(X + m + diag - 1 - i); },
          max(0, diag - (en - m)), min(diag, m - s));
      if (lane == 0) {
        if (warp == 0) {
          sm.j0 = j, sm.s0 = s, sm.m0 = m, sm.e0 = en, sm.ia = i, sm.ka = diag - i;
        } else {
          sm.j1 = j, sm.s1 = s, sm.m1 = m, sm.ic = i, sm.kc = diag - i;
        }
      }
    }
  }
  __syncthreads();
  const int j0 = sm.j0, s0 = sm.s0, ia = sm.ia, ka = sm.ka;
  const int j1 = sm.j1, s1 = sm.s1, ic = sm.ic, kc = sm.kc;
  const int ilo = sm.ilo;
  // the tile writes the offsets of the jobs that start in [d, e), the
  // last tile also those at P; it reads lo[2 jlo .. 2 jhi]
  const int ihi = t == tiles - 1 ? a.jobs + 1 : j1 + 1;
  const int jlo = min(ilo, j0), jhi = max(j1 + 1, ihi - 1);
  const int nlo = 2 * (jhi - jlo) + 1;
  const bool staged = nlo <= kLoCap;

  // stage the words: job j0's A part at [0, l0), its B part at [l0, l1);
  // when j1 > j0, the whole jobs and j1's A part at [l1, q1), where local
  // position q holds X[d + q], and j1's B part at [q1, e - d)
  {
    const int m0 = sm.m0, e0 = sm.e0, m1 = sm.m1;
    const int l0 = (j1 == j0 ? ic : m0 - s0) - ia;
    const int l1 = l0 + (j1 == j0 ? kc : e0 - m0) - ka;
    const int q1 = j1 == j0 ? e - d : s1 - d + ic;
    uint32_t w[kPer];
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int q = tid + x * kThreads;
      const int src = q < l0 ? s0 + ia + q : q < l1 ? m0 + ka + (q - l0) : q < q1 ? d + q : m1 + (q - q1);
      w[x] = q < e - d ? __ldcg(X + src) : 0u;
    }
    if (tid == 0 && d > s0) {  // the larger of the last words before the split
      const uint32_t pa = ia > 0 ? __ldcg(X + s0 + ia - 1) : 0u;
      const uint32_t pb = ka > 0 ? __ldcg(X + m0 + ka - 1) : 0u;
      sm.prev = max(pa, pb);
    }
    if (staged) {
      for (int q = tid; q < nlo; q += kThreads) sm.lo[q] = glo(2 * jlo + q);
    }
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int q = tid + x * kThreads;
      if (q < e - d) sm.words[q] = w[x];
    }
  }
  __syncthreads();
  auto lo_at = [&](int i) { return staged ? sm.lo[i - 2 * jlo] : glo(i); };
  auto start = [&](int j) { return lo_at(2 * j); };  // job j's first position

  // this thread's positions [p0, p1): their words and keep bits
  const int p0 = d + tid * kPer;
  const int p1 = min(p0 + kPer, e);
  const uint32_t* W = sm.words;
  uint32_t v[kPer];
  unsigned bits = 0;
  if (p0 < e) {
    // job j's parts in the tile: A at W[sa, sa + na), B at W[sb, sb +
    // nb); its positions [base, jend)
    int j, base, sa, na, sb, nb, jend;
    auto place = [&](int jj) {
      j = jj;
      const int s = start(j), m = lo_at(2 * j + 1), en = lo_at(2 * j + 2);
      base = max(s, d);
      na = (j == j1 ? ic : m - s) - (j == j0 ? ia : 0);
      nb = (j == j1 ? kc : en - m) - (j == j0 ? ka : 0);
      sa = base - d;
      sb = sa + na;
      jend = base + na + nb;
    };
    place(upper_in(start, j0 + 1, j1 + 1, p0) - 1);
    const int diag = p0 - base;
    int lo = max(0, diag - nb), hi = min(diag, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (W[sa + mid] <= W[sb + diag - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    int i = lo, k = diag - lo;
    // the word merged before p0, in this job
    bool has_prev = diag > 0 || (j == j0 && d > s0);
    uint32_t prev = diag > 0 ? 0u : sm.prev;
    if (diag > 0 && i > 0) prev = W[sa + i - 1];
    if (diag > 0 && k > 0) prev = max(prev, W[sb + k - 1]);
    // the next word of A and of B in registers: a step reads one word
    uint32_t ha = i < na ? W[sa + i] : 0u, hb = k < nb ? W[sb + k] : 0u;
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int p = p0 + x;
      if (p >= p1) break;
      if (p >= jend) {  // the next job with a word starts at p
        place(upper_in(start, j + 1, j1 + 1, p) - 1);
        i = k = 0;
        has_prev = false;
        ha = na > 0 ? W[sa] : 0u;
        hb = nb > 0 ? W[sb] : 0u;
      }
      const bool take_a = i < na && (k >= nb || ha <= hb);
      const uint32_t w = take_a ? ha : hb;
      if (take_a) {
        ++i;
        ha = i < na ? W[sa + i] : 0u;
      } else {
        ++k;
        hb = k < nb ? W[sb + k] : 0u;
      }
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
  if (lane == 31) sm.warp_sum[warp] = incl;
  __syncthreads();  // every thread's merge has read the staged words
  int before_warp = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before_warp += w < warp ? sm.warp_sum[w] : 0;
    total += sm.warp_sum[w];
  }
  const int mine = before_warp + incl - c;
  sm.before[tid] = mine;
  sm.bits[tid] = bits;
#pragma unroll
  for (int x = 0; x < kPer; ++x) {  // the kept words at their rank in the tile
    if ((bits >> x) & 1u) sm.words[mine + __popc(bits & ((1u << x) - 1u))] = v[x];
  }
  const int gex = look_back_block(a.status, t, total, sm.first, sm.sums);
  __syncthreads();

  // kept words before local position q (q <= kTile)
  auto rank = [&](int q) {
    if (q >= kTile) return total;
    const int th = q / kPer;
    return sm.before[th] + __popc(sm.bits[th] & ((1u << (q % kPer)) - 1u));
  };
  for (int q = tid; q < total; q += kThreads) a.out[gex + q] = sm.words[q];
  for (int i = ilo + tid; i < ihi; i += kThreads) a.out_off[i] = gex + rank(start(i) - d);
  __syncthreads();  // before the next tile reuses the shared state
}

// this round's positions, read on the card, and its tiles
__device__ __forceinline__ int round_positions(const UnionArgs& a) {
  return __ldcg(a.lo + a.n);
}

__device__ __forceinline__ int tiles_of(int P) { return P / kTile + (P % kTile != 0); }

// K4: one round, tiles from the call's ticket, each taken when the CTA
// is free for it (a ticket taken ahead, while the CTA's tile runs, makes
// the tiles after it wait on a tile not yet started).
__global__ void __launch_bounds__(kThreads, kMinCtas) setop_union_pairs(UnionArgs a) {
  __shared__ UnionShared sm;
  const int P = round_positions(a);
  const int tiles = tiles_of(P);
  for (;;) {
    if (threadIdx.x == 0) sm.tile = atomicAdd(a.ticket, 1);
    __syncthreads();
    const int t = sm.tile;
    if (t >= tiles) return;  // the same for every thread
    union_tile(a, sm, t, P, tiles);
  }
}

struct MergeArgs {
  const uint32_t* X;
  const int32_t* lo;  // k + 1 list offsets
  int k, rounds;
  uint32_t* out0;     // round r writes out and off of r % 2
  uint32_t* out1;
  int32_t* off0;      // ceil(k / 2) + 1 each
  int32_t* off1;
  unsigned long long* status;  // rounds x tiles words, zeroed
  int tiles;          // tiles of the input's words: the stride of status
  int32_t* arrived;   // the grid barrier's count, zeroed
};

// Every CTA of the grid past this point once everyone's writes before it
// are visible: CTA arrivals counted, `target` in all (a cooperative
// launch, so every CTA is resident).
__device__ __forceinline__ void grid_barrier(int32_t* arrived, int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1);
    while (load_relaxed_i32(arrived) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// K5: every round of the k-way merge in one cooperative launch.
__global__ void __launch_bounds__(kThreads, kMinCtas) setop_merge_rounds(MergeArgs m) {
  __shared__ UnionShared sm;
  UnionArgs a{};
  a.X = m.X;
  a.lo = m.lo;
  a.n = m.k;
  for (int r = 0; r < m.rounds; ++r) {
    a.jobs = (a.n + 1) / 2;
    a.out = r & 1 ? m.out1 : m.out0;
    a.out_off = r & 1 ? m.off1 : m.off0;
    a.status = m.status + (long long)r * m.tiles;
    const int P = round_positions(a);
    const int tiles = tiles_of(P);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) union_tile(a, sm, t, P, tiles);
    if (r + 1 < m.rounds) {
      grid_barrier(m.arrived, (r + 1) * (int)gridDim.x);
      a.X = a.out;
      a.lo = a.out_off;
      a.n = a.jobs;
    }
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
  extern __shared__ __align__(16) uint32_t sw[];  // a list's window, or its sample
  __shared__ uint32_t bits[kChunks];              // keep bits of each chunk
  __shared__ int chunk_off[kChunks + 1];          // kept before each chunk; the tile's total
  __shared__ int s_tile, s_bound[kBatch][2];      // a round's windows [lo, hi) in X
  __shared__ int s_first[kWarps];                 // the look-back's scratch
  __shared__ long long s_sums[kWarps];
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
    bool left = true;  // a word of the tile still kept: the same for every thread
    for (int l0 = 1; left && l0 < a.k; l0 += kBatch) {
      const int nl = min(kBatch, a.k - l0);
      // the windows of lists l0 .. l0 + nl - 1 between the tile's first and
      // last word, all at once: warp 2i finds list l0 + i's lower bound,
      // warp 2i + 1 its upper
      if (warp < 2 * nl) {
        const int l = l0 + (warp >> 1);
        const int ls = __ldg(a.lo + l);
        const int ln = max(__ldg(a.lo + l + 1) - ls, 0);
        const int at = warp_search([&](int i) { return __ldg(a.X + ls + i); }, ln,
                                   warp & 1 ? last : first, (warp & 1) != 0);
        if (lane == 0) s_bound[warp >> 1][warp & 1] = ls + at;
      }
      __syncthreads();  // the round's windows
      for (int i = 0; i < nl; ++i) {
        const int wlo = s_bound[i][0];
        const int wn = max(s_bound[i][1] - wlo, 0);
        const uint32_t* W = a.X + wlo;
        // the window whole when it fits, else every stride-th word of it
        const int stride = wn <= kWindowMax ? 1 : (wn + kWindowMax - 1) / kWindowMax;
        const int ns = (wn + stride - 1) / stride;
        stage_words(sw, W, ns, stride);
        __syncthreads();  // the window or its sample staged
        if (stride == 1) {
          int at[kPer], n[kPer];
#pragma unroll
          for (int x = 0; x < kPer; ++x) {
            at[x] = 0;
            n[x] = (alive >> x) & 1u ? wn : 0;
          }
          alive &= member_all<false>(sw, at, n, v);
        } else {
          alive &= member_sampled(sw, ns, W, wn, stride, alive, v);
        }
        // also: every search has read sw before the next list overwrites it
        left = __syncthreads_or(alive != 0);
        if (!left) break;
      }
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
    if (warp == 0) chunk_scan(bits, chunk_off);
    __syncthreads();
    const int total = chunk_off[kChunks];
    const int gex = look_back_block(a.status, t, total, s_first, s_sums);
    if (tid == 0 && t == tiles - 1) a.head[1] = gex + total;
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

// The CTAs of a kernel the card holds at once, per device, asked once.
constexpr int kMaxDevices = 64;
enum { kUnionKernel, kMergeKernel, kManyKernel, kKernels };
std::atomic<int> g_resident[kKernels][kMaxDevices];

// Switch to `device`, zero `zero_words` words of buf on `stream`, and
// find how many CTAs of `kernel` the card holds at once.
template <typename Kernel>
int prepare(int which, Kernel kernel, size_t dyn, int device, int32_t* buf, size_t zero_words,
            cudaStream_t stream, int& cur, int64_t& resident) {
  cur = -1;
  int err = (int)cudaGetDevice(&cur);
  if (!err && cur != device) err = (int)cudaSetDevice(device);
  if (!err) err = (int)cudaMemsetAsync(buf, 0, zero_words * 4, stream);
  const bool cached = device >= 0 && device < kMaxDevices;
  int n = cached ? g_resident[which][device].load(std::memory_order_relaxed) : 0;
  if (!err && n == 0) {
    int per_sm = 0, sms = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, dyn);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    n = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    if (!err && cached) g_resident[which][device].store(n, std::memory_order_relaxed);
  }
  resident = n;
  return err;
}

// Where setop_merge_launch puts each part of its buffer, in int32 words:
// the status words (2 words a tile of cap, a round), the barrier's count
// and a pad word, the offsets of rounds 0, 2, .. and of rounds 1, 3, ..
// (ceil(k / 2) + 1 each), then the words of rounds 0, 2, .. and of rounds
// 1, 3, .. (cap each; the second only when there are 2 rounds or more).
// The memset zeroes everything before the words.
struct MergeLayout {
  int64_t tiles, rounds, arrived, off[2], out[2], zeroed, words;
};

MergeLayout merge_layout(int k, int cap) {
  MergeLayout L{};
  L.tiles = ((int64_t)cap + kTile - 1) / kTile;
  L.rounds = 1;
  while ((1ll << L.rounds) < k) ++L.rounds;  // ceil(log2 k), at least 1
  const int64_t jobs = (k + 1) / 2;
  L.arrived = 2 * L.tiles * L.rounds;
  L.off[0] = L.arrived + 2;
  L.off[1] = L.off[0] + jobs + 1;
  L.zeroed = L.off[1] + jobs + 1;
  L.out[0] = L.zeroed;
  L.out[1] = L.zeroed + cap;
  L.words = L.zeroed + (L.rounds > 1 ? 2 : 1) * (int64_t)cap;
  return L;
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
  int err = prepare(kUnionKernel, setop_union_pairs, 0, device, buf,
                    (size_t)(2 * tiles + a.jobs + 1 + 1), stream, cur, resident);
  if (!err && tiles > 0) {
    const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
    setop_union_pairs<<<grid, kThreads, 0, stream>>>(a);
    err = (int)cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return err;
}

// The layout of setop_merge_launch's buffer for k lists of at most cap
// words: into[0] its int32 words, into[1] the words the call zeroes,
// into[2] where the answer's words start, into[3] where its offsets (0,
// count) are.
void setop_merge_layout(int k, int cap, long long* into) {
  const MergeLayout L = merge_layout(k, cap);
  const int last = (int)((L.rounds - 1) & 1);
  into[0] = L.words;
  into[1] = L.zeroed;
  into[2] = L.out[last];
  into[3] = L.off[last];
}

// The k-way merge: every round of the pair union over the k lists of X
// (offsets lo, k + 1 of them, lo[0] = 0, at most cap words), in one
// cooperative launch. buf (int32 words, 8-byte aligned) as merge_layout
// says; the call zeroes its head on `stream`, then launches the kernel.
// Returns 0 or the cudaError_t of the first call that failed (a grid the
// card cannot hold at once among them: there is no fallback).
int setop_merge_launch(const int32_t* X, const int32_t* lo, int k, int cap, int32_t* buf,
                       int device, cudaStream_t stream) {
  if (k <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const MergeLayout L = merge_layout(k, cap);
  MergeArgs m{};
  m.X = reinterpret_cast<const uint32_t*>(X);
  m.lo = lo;
  m.k = k;
  m.rounds = (int)L.rounds;
  m.status = reinterpret_cast<unsigned long long*>(buf);
  m.tiles = (int)L.tiles;
  m.arrived = buf + L.arrived;
  m.off0 = buf + L.off[0];
  m.off1 = buf + L.off[1];
  m.out0 = reinterpret_cast<uint32_t*>(buf + L.out[0]);
  m.out1 = reinterpret_cast<uint32_t*>(buf + L.out[1]);
  int cur;
  int64_t resident;
  int err = prepare(kMergeKernel, setop_merge_rounds, 0, device, buf, (size_t)L.zeroed, stream,
                    cur, resident);
  if (!err && L.tiles > 0) {
    const unsigned grid = (unsigned)(L.tiles < resident ? L.tiles : resident);
    void* args[] = {&m};
    err = (int)cudaLaunchCooperativeKernel((const void*)setop_merge_rounds, dim3(grid),
                                           dim3(kThreads), args, 0, stream);
    if (!err) err = (int)cudaGetLastError();
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
  int err = prepare(kManyKernel, setop_intersect_many, dyn, device, buf, (size_t)(2 * tiles + 3),
                    stream, cur, resident);
  if (!err && tiles > 0) {
    const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
    setop_intersect_many<<<grid, kThreads, dyn, stream>>>(a);
    err = (int)cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return err;
}

}  // extern "C"
