// Per-row band bounds of --sw-mode banded, built on the card (sm_90a): the
// reference tool's chained k-mer band (k = 6, w = 20) of every (read,
// haplotype) problem of a launch of the banded DP (csrc/sw_banded.cu).
// Problems come in sw_pair.cu's two layouts: per_read == 2, problem p is
// read p/2 against idx_ref (p even) or idx_alt (p odd), the native host
// path's (ref, alt) pairs; per_read == 1, problem p is read p against
// idx_ref[p], the plain rows of the Python host path (K4's own entry,
// vartrix_tpu/ops/sw_pallas_v2.py:1908 `_sw_banded_pairs`: x [B, lx]
// against y [B, ly]), each problem once.
//
// Replaces no TPU kernel: the JAX package builds these bounds on the host
// (vartrix_tpu/ops/sw_pallas_v2.py:1945 make_banded_tpu_scorer, through
// banded_bounds_batch_native). The port keeps a host copy of that
// construction, csrc/band_bounds.cpp, as this kernel's exact reference: the
// bounds are the same int32 values, bit for bit:
//   * true lengths: len_x up to the read's last byte that is not 0, len_y
//     up to the haplotype's last byte that is not 1; either 0: every row
//     empty;
//   * len_x or len_y < k: every read row [0, len_y);
//   * matches: every (i, j) with x[i..i+6) == y[j..j+6) as raw bytes (six
//     bytes packed in a uint64 key compare exactly), ordered by (i, j);
//     none: every row empty;
//   * the chain DP over the matches in that order: each starts at 6; the 64
//     matches before it are visited, those with b.i >= a.i or b.j >= a.j
//     skipped; a predecessor is taken only on a strictly greater score
//     (the nearest wins a tie); the chain ends at the first match of the
//     strictly greatest score;
//   * the fill: each anchor's diagonal widened by w, the box between
//     consecutive anchors, the two corner diagonals, clamped to
//     [0, len_x) x [0, len_y); rows left uncovered or past len_x: [0, 0).
//
// Design. Matches are looked up in a per-haplotype k-mer index, built once
// for a haplotype matrix and kept for every launch over it (ops/sw_cuda
// band_index builds it once per shape bucket):
//   1. the index build: per haplotype row its true length, then its
//      len_y - 5 6-mer keys sorted by (key, j), so the matches of one read
//      6-mer are one run of the sorted keys, ascending in j. Two width
//      routes (ops/sw_cuda.index_route picks one by ly):
//      * index_shared_kernel, while a row's keys fit on chip (at most
//        kSortMaxKeys, ly <= 8,197): a group of threads per row, each
//        holding kSortPerThread composite words key << 16 | j (unique, so
//        the sort needs no stability rule; j < 2^16 on this route); a
//        warp per row and 8 rows per block up to 256 keys, else
//        sort / kSortPerThread threads and one row per block. The block's
//        rows are loaded once, in aligned words, into shared memory; each
//        thread builds its keys from 5 of those words by funnel shifts;
//        then a bitonic network over the row's keys rounded up to a power
//        of two (sentinels past n): strides within a thread in registers,
//        within a warp by shuffles, across warps through shared memory.
//        The sorted row goes once through shared memory and out
//        coalesced: no scratch in device memory. Its bound is the bytes
//        (the rows read once, 12 bytes a key and 4 a row written once),
//        below one launch's own cost at the main path's shapes;
//      * index_kernel, past that: one block per row, runs of 1, 2, 4, ...
//        merged in global memory (each element finds its place by a
//        binary search in the other run; on equal keys the left run's
//        elements, of smaller j, go first), alternating with scratch of
//        the index's size.
//      Pad rows (len_y = 0) stop after the length scan;
//   2. count_kernel: one warp per problem; each lane takes one read
//      position, looks its key up (a binary search for the run's start,
//      a gallop for its end) and adds the run's length. The wrapper sums the counts on the card (torch.cumsum) and
//      reads the total once, so the match scratch is sized exactly: a
//      repetitive pair may have (len_x - 5)(len_y - 5) matches, and the
//      traceback needs every match's predecessor. Where all of a launch's
//      matches would not fit the wrapper's scratch budget, it reads every
//      problem's sum, cuts the problems into ranges that fit and runs the
//      chain pass once per range;
//   3. chain_kernel: one warp per problem of a range, 8 problems per
//      block. The DP: the warp looks up the runs of 32 read positions at
//      once, lays their matches in (i, j) order into chunks of 32, match
//      c + l of a chunk in lane l (its j loaded by that lane), and scores
//      a chunk's matches one warp step each: the last 64 matches are two
//      links per lane (the chunk before, and this chunk's or the one two
//      back), so each lane scores two candidates and one __reduce_max_sync
//      over (score x 64 + nearness) keys applies the tie rules; lane t
//      keeps match t's link and key, and the chunk's best match is found
//      once per chunk from its lanes' scores. The warp keeps its last 8
//      chunks (matches and predecessor distances) in a shared-memory ring
//      and hands older ones to the match scratch in device memory, 32 per
//      store. The traceback reads them back a chunk at a time from the
//      best match down: the chunk's anchors are its entry match's
//      ancestors, found for all lanes at once by doubling, and each anchor
//      lane widens the rows of its diagonal and of its box up to the next
//      anchor, less what that anchor's own diagonal covers (the next
//      anchor on the same diagonal takes its rows over, and within 15 rows
//      its box), by atomics; then the corner diagonals. Width routes (the
//      wrapper picks one by lx, ops/sw_cuda.band_route): up to
//      BAND_SHARED_LX the band rows live in shared memory and the block
//      writes its 8 problems' row r as 8 consecutive words of the DP's
//      [row][problem] layout; wider reads keep them in a work buffer
//      [problem][row] in device memory, which each warp writes out.
//
// Widths. A chain score is at most len_x, so its key (score x 64 +
// nearness) fits int32 while lx < 2^25; past that the wrapper launches the
// instantiation with 64-bit keys (two 32-bit warp reductions per match).
// Match counts and scratch offsets are 64-bit; the DP step itself counts
// only the 32 matches of a chunk and a predecessor is stored as its
// distance (1..64), so no per-match value passes 2^31.
//
// Bound. The bytes are small (reads, haplotypes and indices in, 8 bytes of
// bounds per read row and problem out); the work is integer instructions:
// len_x - 5 key lookups per problem plus, per match, its up to 64 chain
// candidates at the cost of scoring one (`candidate` and one max), at the
// instruction issue rate (chip_smoke.py prints both, and this kernel's own
// SASS instructions per candidate beside them). The DP step scores a
// candidate in fewer instructions than `candidate` and shares the
// per-match upkeep (the broadcast, the reduction, the key's decoding, lane
// t's link) over 64 candidates, so the bound over-charges the candidates
// and chip_smoke.py reports no share of it; instead it splits the chain
// pass into its lookups, its DP steps and its traceback with the fill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 6;         // k-mer length of the seeds
constexpr int kW = 20;        // half-width of the band around an anchor
constexpr int kMaxPred = 64;  // matches before each match the DP visits
constexpr int kMatch = 1;
constexpr int kGapOpen = -5;
constexpr int kGapExtend = -1;
constexpr int kThreads = 128;  // count pass: a warp per problem
constexpr int kWarps = kThreads / 32;
constexpr int kChainThreads = 256;  // chain pass: a warp per problem
constexpr int kChainWarps = kChainThreads / 32;
constexpr int kRing = 8;  // chunks of 32 matches a warp keeps on the chip
constexpr int kIndexThreads = 256;  // the global index route: a row a block
// The shared index route: keys per thread, per warp, per row at most, and
// rows per block of a warp per row
constexpr int kSortPerThread = 8;
constexpr int kSortWarpKeys = 32 * kSortPerThread;
constexpr int kSortMaxKeys = 8192;
constexpr int kSortWarpRows = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long kmer_key(
    const uint8_t* __restrict__ p) {
  unsigned long long key = 0;
#pragma unroll
  for (int t = 0; t < kK; ++t) {
    key |= static_cast<unsigned long long>(__ldg(p + t)) << (8 * t);
  }
  return key;
}

// Length of a row up to its last byte that is not `pad`, by one warp.
__device__ int warp_true_len(const uint8_t* __restrict__ row, int width,
                             uint8_t pad) {
  const int lane = threadIdx.x & 31;
  for (int base = width; base > 0; base -= 32) {
    const int pos = base - 32 + lane;
    const unsigned m =
        __ballot_sync(kFull, pos >= 0 && __ldg(row + pos) != pad);
    if (m) return base - 32 + (31 - __clz(m)) + 1;
  }
  return 0;
}

// First index of a[0, n) whose key is not below v (kOrEqual: above v).
template <bool kOrEqual>
__device__ __forceinline__ int search(const unsigned long long* a, int n,
                                      unsigned long long v) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    const unsigned long long k = a[lo + half];
    if (kOrEqual ? k <= v : k < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The index of one haplotype row: its true length, then keys[0, n) and
// pos[0, n) (n = len_y - 5) its 6-mer keys and their positions, sorted by
// (key, j). The merge passes alternate between (keys, pos) and (tmp_keys,
// tmp_pos), starting where the last pass ends in (keys, pos). Plain loads:
// the buffers are written inside this kernel.
__global__ void __launch_bounds__(kIndexThreads)
index_kernel(const uint8_t* __restrict__ haps, int ly,
             unsigned long long* keys, int32_t* pos,
             unsigned long long* tmp_keys, int32_t* tmp_pos,
             int32_t* __restrict__ hap_len) {
  const size_t h = blockIdx.x;
  const uint8_t* row = haps + h * ly;
  __shared__ int s_len;
  if (threadIdx.x < 32) {
    const int len = warp_true_len(row, ly, 1);
    if (threadIdx.x == 0) {
      s_len = len;
      hap_len[h] = len;
    }
  }
  __syncthreads();
  const int n = s_len - kK + 1;
  if (n <= 0) return;
  const int passes = n > 1 ? 32 - __clz(n - 1) : 0;
  unsigned long long* ka = (passes & 1 ? tmp_keys : keys) + h * ly;
  unsigned long long* kb = (passes & 1 ? keys : tmp_keys) + h * ly;
  int32_t* pa = (passes & 1 ? tmp_pos : pos) + h * ly;
  int32_t* pb = (passes & 1 ? pos : tmp_pos) + h * ly;
  for (int j = threadIdx.x; j < n; j += kIndexThreads) {
    ka[j] = kmer_key(row + j);
    pa[j] = j;
  }
  __syncthreads();
  for (int w = 1; w < n; w <<= 1) {
    for (int e = threadIdx.x; e < n; e += kIndexThreads) {
      const int start = e & ~(2 * w - 1);  // the merged pair's first element
      const bool left = (e & w) == 0;
      const unsigned long long v = ka[e];
      int at;
      if (left) {
        const int m = max(0, min(w, n - start - w));
        at = e + search<false>(ka + start + w, m, v);
      } else {
        at = e - w + search<true>(ka + start, w, v);
      }
      kb[at] = v;
      pb[at] = pa[e];
    }
    __syncthreads();
    unsigned long long* kt = ka;
    ka = kb;
    kb = kt;
    int32_t* pt = pa;
    pa = pb;
    pb = pt;
  }
}

// The shared index route's launch shape for rows of width ly: the sort
// size (the n = ly - 5 keys rounded up to a power of two, at least a
// warp's kSortWarpKeys), threads per row (kSortPerThread keys each), rows
// per block and the block's shared bytes (each row's keys at a stride of
// group + 1 words per key slot, then the rows' bytes as words); sort 0
// when a row's keys do not fit (more than kSortMaxKeys).
struct IndexShape {
  int sort, group, rows;
  size_t smem;
};

// Words of the block's row bytes in shared memory: the rows, up to 3
// bytes of alignment before them and the 4 words a thread's last keys
// read past its row.
__host__ __device__ __forceinline__ int index_words(int ly, int rows) {
  return static_cast<int>((static_cast<long long>(rows) * ly + 3) / 4 + 5);
}

IndexShape index_shape(int ly) {
  const int n = ly > kK - 1 ? ly - kK + 1 : 0;
  int sort = kSortWarpKeys;
  while (sort < n && sort <= kSortMaxKeys) sort <<= 1;
  if (sort > kSortMaxKeys) return IndexShape{0, 0, 0, 0};
  const int group = sort / kSortPerThread;
  const int rows = group == 32 ? kSortWarpRows : 1;
  const size_t smem = sizeof(unsigned long long) * rows * kSortPerThread *
                          (group + 1) +
                      sizeof(uint32_t) * index_words(ly, rows);
  return IndexShape{sort, group, rows, smem};
}

// A bitonic compare-exchange within a thread: (a, b) ascending when asc,
// else descending.
__device__ __forceinline__ void sort_pair(unsigned long long& a,
                                          unsigned long long& b, bool asc) {
  const bool swap = (a > b) == asc;
  const unsigned long long lo = swap ? b : a, hi = swap ? a : b;
  a = lo;
  b = hi;
}

// A bitonic compare-exchange across threads: this thread's v against its
// partner's w, the lesser kept when keep_min, else the greater.
__device__ __forceinline__ unsigned long long sort_keep(unsigned long long v,
                                                        unsigned long long w,
                                                        bool keep_min) {
  return (v < w) == keep_min ? v : w;
}

// The index of `rows_per_block` haplotype rows by groups of `group`
// threads (kWarpRows: a warp per row, kSortWarpRows rows; else one row of
// `group` threads): the rows' bytes into shared memory as aligned words;
// a row's true length by a reduction; thread t's keys i = t kSortPerThread
// + r as composites key << 16 | i (~0 past n); a bitonic sort of the
// first `size` (n rounded up to a power of two) in registers, shuffles
// and, between warps, shared memory; then the row out through shared
// memory, n keys and positions, coalesced.
template <bool kWarpRows>
__global__ void __launch_bounds__(1024)
index_shared_kernel(const uint8_t* __restrict__ haps, int n_haps, int ly,
                    int group, int rows_per_block,
                    unsigned long long* __restrict__ keys,
                    int32_t* __restrict__ pos,
                    int32_t* __restrict__ hap_len) {
  constexpr int kE = kSortPerThread;
  extern __shared__ unsigned long long s_sort[];
  __shared__ int s_len;
  const int stride = group + 1;  // words from a thread's slot r to r + 1
  uint32_t* s_words = reinterpret_cast<uint32_t*>(
      s_sort + static_cast<size_t>(rows_per_block) * kE * stride);
  const int words = index_words(ly, rows_per_block);
  const size_t h0 = static_cast<size_t>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block),
          n_haps - static_cast<long long>(h0)));
  // word k: the bytes from span - a + 4k on (a: the span's offset from an
  // aligned word), zero outside the span; only words inside it are loaded
  // whole
  const uint8_t* span = haps + h0 * ly;
  const long long n_bytes = static_cast<long long>(rows) * ly;
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(span) & 3);
  const uint32_t* span_words = reinterpret_cast<const uint32_t*>(span - a);
  for (int k = threadIdx.x; k < words; k += blockDim.x) {
    const long long b0 = 4ll * k - a;
    uint32_t w = 0;
    if (b0 >= 0 && b0 + 4 <= n_bytes) {
      w = __ldg(span_words + k);
    } else {
      for (int t = 0; t < 4; ++t) {
        if (b0 + t >= 0 && b0 + t < n_bytes) {
          w |= static_cast<uint32_t>(__ldg(span + b0 + t)) << (8 * t);
        }
      }
    }
    s_words[k] = w;
  }
  if (!kWarpRows && threadIdx.x == 0) s_len = 0;
  __syncthreads();
  const int rho = threadIdx.x / group, t = threadIdx.x % group;
  if (rho >= rows) return;  // a warp of the last block without a row
  const uint8_t* row =
      reinterpret_cast<const uint8_t*>(s_words) + a + rho * ly;
  int len = 0;
  for (int j = t; j < ly; j += group) {
    if (row[j] != 1) len = j + 1;
  }
  len = __reduce_max_sync(kFull, len);
  if (!kWarpRows) {
    if ((threadIdx.x & 31) == 0) atomicMax(&s_len, len);
    __syncthreads();
    len = s_len;
  }
  const size_t h = h0 + rho;
  if (t == 0) hap_len[h] = len;
  const int n = len - kK + 1;
  if (n <= 0) return;
  // keys i0 .. i0 + 7 from bytes o .. o + 12 of the words: u, the words
  // aligned to byte o, then each key's 6 bytes from two of them
  unsigned long long v[kE];
  const int i0 = t * kE;
  if (i0 < n) {
    const int o = a + rho * ly + i0;
    uint32_t w[5], u[4];
#pragma unroll
    for (int q = 0; q < 5; ++q) w[q] = s_words[(o >> 2) + q];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u[q] = __funnelshift_r(w[q], w[q + 1], 8 * (o & 3));
    }
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const int q = r >> 2, s = 8 * (r & 3);
      const uint32_t lo = __funnelshift_r(u[q], u[q + 1], s);
      const uint32_t hi = __funnelshift_r(u[q + 1], u[q + 2], s) & 0xffffu;
      const unsigned long long key =
          (static_cast<unsigned long long>(hi) << 32) | lo;
      v[r] = i0 + r < n ? key << 16 | static_cast<unsigned>(i0 + r) : ~0ull;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kE; ++r) v[r] = ~0ull;
  }
  // the bitonic network over the first `size` slots: stage k sorts runs
  // of k, ascending where slot i has (i & k) == 0; a step of stride j
  // pairs i with i ^ j, the lesser to the lower slot of an ascending run
  int size = 1;
  while (size < n) size <<= 1;
  unsigned long long* s_row = s_sort + static_cast<size_t>(rho) * kE * stride;
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j >= kE; j >>= 1) {
      const int m = j / kE;  // the partner: thread t ^ m, the same slot r
      const bool keep_min = ((t & m) == 0) == ((i0 & k) == 0);
      if (kWarpRows || m < 32) {
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          v[r] = sort_keep(v[r], __shfl_xor_sync(kFull, v[r], m), keep_min);
        }
      } else {
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kE; ++r) s_row[r * stride + t] = v[r];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          v[r] = sort_keep(v[r], s_row[r * stride + (t ^ m)], keep_min);
        }
      }
    }
#pragma unroll
    for (int jj = kE / 2; jj > 0; jj >>= 1) {
      if (jj < k) {
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          if ((r & jj) == 0) sort_pair(v[r], v[r | jj], ((i0 + r) & k) == 0);
        }
      }
    }
  }
  // slot i = t kE + r at s_row[r * stride + t], then out in i order
  if (kWarpRows) {
    __syncwarp();
  } else {
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kE; ++r) s_row[r * stride + t] = v[r];
  if (kWarpRows) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  unsigned long long* out_keys = keys + h * ly;
  int32_t* out_pos = pos + h * ly;
  for (int e = t; e < n; e += group) {
    const unsigned long long c = s_row[(e % kE) * stride + e / kE];
    out_keys[e] = c >> 16;
    out_pos[e] = static_cast<int32_t>(c & 0xffffu);
  }
}

// One problem as the warp sees it.
struct Problem {
  const uint8_t* x;                // read bytes
  int len_x;
  const unsigned long long* keys;  // the haplotype's sorted 6-mer keys
  const int32_t* pos;              // and their positions
  int len_y;
};

__device__ Problem load_problem(const uint8_t* __restrict__ reads, int lx,
                                int ly, const int32_t* __restrict__ idx_ref,
                                const int32_t* __restrict__ idx_alt,
                                int per_read,
                                const unsigned long long* __restrict__ keys,
                                const int32_t* __restrict__ pos,
                                const int32_t* __restrict__ hap_len,
                                size_t p) {
  const bool pair = per_read == 2;
  const size_t read = pair ? p >> 1 : p;
  const size_t hidx = __ldg(((pair && (p & 1)) ? idx_alt : idx_ref) + read);
  Problem q;
  q.x = reads + read * lx;
  q.len_x = warp_true_len(q.x, lx, 0);
  q.keys = keys + hidx * ly;
  q.pos = pos + hidx * ly;
  q.len_y = __ldg(hap_len + hidx);
  return q;
}

// This lane's run [lo, hi) of the haplotype's sorted keys: the matches of
// read position i (none when i >= n_i). The run's start by a binary
// search; its end by galloping from there (runs are mostly 0 or 1 long),
// then a binary search within the last gallop.
__device__ __forceinline__ void lookup(const Problem& q, int i, int n_i,
                                       int n_j, int& lo, int& hi) {
  lo = hi = 0;
  if (i < n_i) {
    const unsigned long long kx = kmer_key(q.x + i);
    lo = search<false>(q.keys, n_j, kx);
    hi = lo;
    if (lo < n_j && q.keys[lo] == kx) {  // keys[hi] == kx
      int step = 1;
      while (hi + step < n_j && q.keys[hi + step] == kx) {
        hi += step;
        step <<= 1;
      }
      const int end = min(hi + step, n_j);
      hi += 1 + search<true>(q.keys + hi + 1, end - hi - 1, kx);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ reads, size_t n_prob, int lx, int ly,
             const int32_t* __restrict__ idx_ref,
             const int32_t* __restrict__ idx_alt, int per_read,
             const unsigned long long* __restrict__ keys,
             const int32_t* __restrict__ pos,
             const int32_t* __restrict__ hap_len,
             long long* __restrict__ counts) {
  const size_t p = static_cast<size_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
  if (p >= n_prob) return;
  const int lane = threadIdx.x & 31;
  const Problem q = load_problem(reads, lx, ly, idx_ref, idx_alt, per_read,
                                 keys, pos, hap_len, p);
  long long n = 0;
  if (q.len_x >= kK && q.len_y >= kK) {
    const int n_i = q.len_x - kK + 1, n_j = q.len_y - kK + 1;
    for (int i0 = 0; i0 < n_i; i0 += 32) {
      int lo, hi;
      lookup(q, i0 + lane, n_i, n_j, lo, hi);
      n += hi - lo;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_down_sync(kFull, n, d);
  if (lane == 0) counts[p] = n;
}

// The scoring of one chain candidate that band_build's bound charges
// (chip_smoke.py compiles `candidate` into its probe; the chain pass
// computes the same keys in link_key). A ring slot: one of the last 64
// matches (ring index b, -1 for none yet).
struct Slot {
  int i, j, sc, b;
};

// Candidate key of predecessor s for match a = (i, j) (a, s.b ring
// indices): score x 64 + (63 - distance), so the greatest key is the
// greatest score and, among equal scores, the nearest predecessor; 0 when
// s is skipped or does not beat the start score.
template <typename Key = int>
__device__ __forceinline__ Key candidate(const Slot& s, int a, int i, int j) {
  if (s.b < 0 || s.i >= i || s.j >= j) return 0;
  const int di = i - s.i, dj = j - s.j;
  const int gap = abs(di - dj);
  const int pen = gap > 0 ? -(kGapOpen + gap * kGapExtend) : 0;
  const int overlap = max(0, kK - min(di, dj));
  const int sc = s.sc + (kK - overlap) * kMatch - pen;
  if (sc <= kK * kMatch) return 0;
  return static_cast<Key>(sc) * kMaxPred + (kMaxPred - 1 - (a - 1 - s.b));
}

__device__ __forceinline__ int warp_max(int key) {
  return __reduce_max_sync(kFull, key);
}

__device__ __forceinline__ long long warp_max(long long key) {
  const int hi = __reduce_max_sync(kFull, static_cast<int>(key >> 32));
  const unsigned lo = __reduce_max_sync(
      kFull, static_cast<int>(key >> 32) == hi ? static_cast<unsigned>(key)
                                               : 0u);
  return (static_cast<long long>(hi) << 32) | lo;
}

// The chain pass's ring, as a lane sees it: one of the last 64 matches
// and its chain score (i = INT32_MAX: none yet). The matches come in
// chunks of 32, match c + l of chunk c in lane l; lane l keeps its match
// of the chunk before (`prev`) and, in `cur`, its match of this chunk
// once that is scored, until then its match of the chunk two back.
struct Link {
  int i, j, sc;
};

// Candidate key of link s for match (i, j) at nearness `near` (64 -
// distance: 0 for the match 64 back, 63 for the one before): what
// `candidate` (the scoring of one candidate that band_build's bound
// charges) computes, score x 64 + nearness for a link before (i, j) in
// both coordinates that beats the start score, else 0; here with a
// three-way minimum for the overlap and the gap penalty as g + 5 min(g,
// 1).
template <typename Key>
__device__ __forceinline__ Key link_key(const Link& s, int near, int i,
                                        int j) {
  const int di = i - s.i, dj = j - s.j;  // s.i = INT32_MAX: di < 0
  const int step = __vimin3_s32(di, dj, kK);  // kK - overlap, if > 0
  const int g = abs(di - dj);
  const int pen = g * -kGapExtend - kGapOpen * min(g, 1);
  const int sc = s.sc + step * kMatch - pen;
  return step > 0 && sc > kK * kMatch
             ? static_cast<Key>(sc) * kMaxPred + near
             : 0;
}

// A problem's band rows as the chain pass builds them: read row r's
// bounds at lo[r], hi[r], (INT32_MAX, INT32_MIN) before the fill; widened
// by atomics, as the lanes of a warp widen rows that may overlap.
struct Rows {
  int32_t* lo;
  int32_t* hi;
  // row r: lo = min(lo, a), hi = max(hi, b)
  __device__ __forceinline__ void widen(int r, int a, int b) const {
    atomicMin(lo + r, a);
    atomicMax(hi + r, b);
  }
  // rows r0 + from, r0 + from + step, ... below r1 of diagonal d
  // widened by w, clamped to [0, len_y)
  __device__ __forceinline__ void diag(int r0, int r1, int d, int len_y,
                                       int from, int step) const {
    for (int r = r0 + from; r < r1; r += step) {
      widen(r, max(0, r + d - kW), min(len_y, r + d + kW + 1));
    }
  }
};

// Shared-memory words between one warp's rows and the next's: lx rounded
// up to 4 more than a multiple of 32, so the block's coalesced write (the
// 8 warps' row r in 8 lanes, 4 rows per warp instruction) meets 32 banks.
__host__ __device__ __forceinline__ int shared_stride(int lx) {
  return lx + ((4 - lx) & 31);
}

// A key's score: keys >= 0, 0 for none, which scores the start.
__device__ __forceinline__ int key_score(int key) {
  return max(static_cast<int>(static_cast<unsigned>(key) / kMaxPred),
             kK * kMatch);
}
__device__ __forceinline__ int key_score(long long key) {
  return max(static_cast<int>(static_cast<unsigned long long>(key) /
                              kMaxPred),
             kK * kMatch);
}

// A key's predecessor distance (1..64; 0 for none).
template <typename Key>
__device__ __forceinline__ int key_distance(Key key) {
  return key ? kMaxPred - static_cast<int>(key & (kMaxPred - 1)) : 0;
}

// A warp's last kRing chunks of matches in shared memory: chunk k's
// match c + l's (i, j) and predecessor distance (0: none) at slot k %
// kRing, lane l. Older chunks go to the match scratch in device memory.
struct Ring {
  int2 ij[kRing][32];
  int dist[kRing][32];
};

// A problem's matches as the chain DP leaves them: chunk k's in the ring
// while k is one of the last kRing, else match a's (i, j) and
// predecessor distance at i[a], j[a], prev[a]; the best chain ends at
// match best.
struct Chain {
  const int32_t* i;
  const int32_t* j;
  const int32_t* prev;
  long long count, best;
};

// One warp's chain DP of problem p (see the file's Design), which has
// matches: keeps every match (the ring, then the match scratch) and
// returns where the best chain ends.
template <typename Key>
__device__ __forceinline__ Chain chain_dp(
    const Problem& q, const long long* __restrict__ ends, size_t p,
    size_t p0, int32_t* match_i, int32_t* match_j, int32_t* match_prev,
    Ring& ring) {
  const int lane = threadIdx.x & 31;
  const long long start = p ? ends[p - 1] : 0;
  const long long off = start - (p0 ? ends[p0 - 1] : 0);  // in the range
  int32_t* mi = match_i + off;
  int32_t* mj = match_j + off;
  int32_t* mp = match_prev + off;
  Link cur{INT32_MAX, 0, 0}, prev{INT32_MAX, 0, 0};
  int ci = 0, cj = 0;  // this lane's match of the chunk
  Key ck = 0;          // and its key, once scored
  int filled = 0;      // matches of the chunk gathered so far
  long long base = 0;  // the chunk's first match
  int best_sc = -1;
  long long best_a = 0;
  // the chunk's first n matches, one warp step each, broadcast from the
  // ring: two candidates per lane, one reduction; lane t keeps match t's
  // link and key. Then the chunk's best match. The ring's slot first hands
  // the chunk kRing back to the match scratch, and takes the predecessor
  // distances at the end.
  auto dp_chunk = [&](int n) {
    // -- a chunk's DP starts here --
    const int slot = static_cast<int>(base / 32) & (kRing - 1);
    if (base >= 32 * kRing) {
      const long long old = base - 32 * kRing + lane;
      mi[old] = ring.ij[slot][lane].x;
      mj[old] = ring.ij[slot][lane].y;
      mp[old] = ring.dist[slot][lane];
    }
    ring.ij[slot][lane] = make_int2(ci, cj);
    __syncwarp();
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const int2 m = ring.ij[slot][t];
      const int near = (lane - t) & (kMaxPred - 1);
      const Key key = warp_max(max(link_key<Key>(cur, near, m.x, m.y),
                                   link_key<Key>(prev, near ^ 32, m.x, m.y)));
      const int sc = key_score(key);
      const bool mine = lane == t;
      cur.i = mine ? ci : cur.i;
      cur.j = mine ? cj : cur.j;
      cur.sc = mine ? sc : cur.sc;
      ck = mine ? key : ck;
    }
    // the chunk's first match of its greatest score, if above the best
    const int top = __reduce_max_sync(kFull, lane < n ? cur.sc : -1);
    if (top > best_sc) {
      best_sc = top;
      best_a = base + __ffs(__ballot_sync(kFull, lane < n && cur.sc == top))
               - 1;
    }
    ring.dist[slot][lane] = key_distance(ck);
    __syncwarp();
  };
  const int n_i = q.len_x - kK + 1, n_j = q.len_y - kK + 1;
  for (int i0 = 0; i0 < n_i; i0 += 32) {
    // the runs of 32 read positions, then their matches in order, laid
    // into the chunk's lanes
    int run_lo, run_hi;
    lookup(q, i0 + lane, n_i, n_j, run_lo, run_hi);
    long long incl = run_hi - run_lo;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const long long excl = incl - (run_hi - run_lo);
    const long long total = __shfl_sync(kFull, incl, 31);
    for (long long m0 = 0; m0 < total;) {
      const int take = static_cast<int>(
          total - m0 < 32 - filled ? total - m0 : 32 - filled);
      const long long m = m0 + lane - filled;  // this lane's match
      int src = 0;  // the last position whose run starts at or before m
#pragma unroll
      for (int b = 16; b > 0; b >>= 1) {
        if (__shfl_sync(kFull, excl, src + b) <= m) src += b;
      }
      const int e = __shfl_sync(kFull, run_lo, src) +
                    static_cast<int>(m - __shfl_sync(kFull, excl, src));
      if (lane >= filled && lane < filled + take) {
        ci = i0 + src;
        cj = __ldg(q.pos + e);
      }
      filled += take;
      m0 += take;
      if (filled == 32) {
        dp_chunk(32);
        const Link two_back = prev;
        prev = cur;
        cur = two_back;
        base += 32;
        filled = 0;
      }
    }
  }
  if (filled) dp_chunk(filled);
  return Chain{mi, mj, mp, base + filled, best_a};
}

// One warp's band fill of a chained problem: the traceback, 32 matches at
// a time from the best one down, from the ring or the match scratch. The
// chunk's anchors are the best match's (or the chunk's last anchor's)
// ancestors in the chunk, found for every lane at once by doubling: each
// lane's mask of its ancestors, its 2^k-th ancestor. Each anchor lane then
// widens the rows of its diagonal and of its box up to the next anchor,
// less what that anchor's own diagonal covers; then the lanes widen the
// rows of the two corner diagonals.
__device__ __forceinline__ void chain_fill(const Chain& ch, const Ring& ring,
                                           int len_x, int len_y,
                                           const Rows& rows) {
  const int lane = threadIdx.x & 31;
  for (int r = lane; r < len_x; r += 32) {
    rows.lo[r] = INT32_MAX;
    rows.hi[r] = INT32_MIN;
  }
  __syncwarp();
  const long long in_ring = (ch.count + 31) / 32 - kRing;  // first chunk
  long long c = ch.best;
  bool has_next = false;
  int next_i = 0, next_j = 0, back_i = 0, back_j = 0;
  while (c >= 0) {
    const long long chunk = c & ~31ll;
    int ai = 0, aj = 0, ad = 0;
    if (chunk + lane < ch.count) {
      if (chunk / 32 >= in_ring) {
        const int slot = static_cast<int>(chunk / 32) & (kRing - 1);
        ai = ring.ij[slot][lane].x;
        aj = ring.ij[slot][lane].y;
        ad = ring.dist[slot][lane];
      } else {
        ai = ch.i[chunk + lane];
        aj = ch.j[chunk + lane];
        ad = ch.prev[chunk + lane];
      }
    }
    const int t = static_cast<int>(c - chunk);
    if (c == ch.best) {
      back_i = __shfl_sync(kFull, ai, t);
      back_j = __shfl_sync(kFull, aj, t);
    }
    int up = ad > 0 && ad <= lane ? lane - ad : lane;  // itself: none
    unsigned anc = 1u << lane;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      anc |= __shfl_sync(kFull, anc, up);
      up = __shfl_sync(kFull, up, up);
    }
    const unsigned on = __shfl_sync(kFull, anc, t);  // the chunk's anchors
    const int first = __ffs(on) - 1;
    const int first_d = __shfl_sync(kFull, ad, first);
    c = first_d ? chunk + first - first_d : -1;
    const unsigned above = lane < 31 ? on >> (lane + 1) << (lane + 1) : 0u;
    const int after = above ? __ffs(above) - 1 : lane;
    const int an_i = __shfl_sync(kFull, ai, after);
    const int an_j = __shfl_sync(kFull, aj, after);
    if ((on >> lane) & 1) {
      const bool succ = above || has_next;
      const int si = above ? an_i : next_i, sj = above ? an_j : next_j;
      const int d = aj - ai;
      int r1 = min(ai + kK + kW, len_x);
      bool box = succ;
      if (succ && sj - si == d) {  // the next anchor's diagonal covers
        r1 = min(r1, si - kW);     // the rest of this one's
        box = si - ai > kW - kK + 1;  // and, this near, the box
      }
      rows.diag(max(ai - kW, 0), r1, d, len_y, 0, 1);
      if (box) {
        const int lo = max(0, aj), hi = min(len_y, sj + kK);
        for (int r = max(0, ai); r < min(len_x, si + kK); ++r) {
          rows.widen(r, lo, hi);
        }
      }
    }
    next_i = __shfl_sync(kFull, ai, first);
    next_j = __shfl_sync(kFull, aj, first);
    has_next = true;
  }
  __syncwarp();
  // corner extensions along the chain's end diagonals
  const int back = min(next_i, next_j);
  rows.diag(max(next_i - back - kW, 0), min(next_i + kW, len_x),
            next_j - next_i, len_y, lane, 32);
  const int i1 = back_i + kK, j1 = back_j + kK;
  const int tail = min(len_x - i1, len_y - j1);
  rows.diag(max(i1 - kW, 0), min(i1 + tail + kW, len_x), j1 - i1, len_y,
            lane, 32);
  __syncwarp();
}

// The chain pass: one warp per problem of [p0, p1), kChainWarps problems
// per block. kSharedRows: the warps' band rows in shared memory, written
// out by the block at the end, 8 problems' row r in 8 consecutive words;
// else in the work buffers [problem][row], written out by each warp.
template <typename Key, bool kSharedRows>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const uint8_t* __restrict__ reads, size_t n_prob, int lx, int ly,
             const int32_t* __restrict__ idx_ref,
             const int32_t* __restrict__ idx_alt, int per_read,
             const unsigned long long* __restrict__ keys,
             const int32_t* __restrict__ pos,
             const int32_t* __restrict__ hap_len,
             const long long* __restrict__ ends, size_t p0, size_t p1,
             int32_t* match_i, int32_t* match_j, int32_t* match_prev,
             int32_t* work_lo, int32_t* work_hi, int32_t* __restrict__ jlo,
             int32_t* __restrict__ jhi) {
  extern __shared__ int32_t shared_rows[];
  __shared__ Ring rings[kChainWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t first = p0 + static_cast<size_t>(blockIdx.x) * kChainWarps;
  const size_t p = first + warp;
  const int stride = shared_stride(lx);
  Rows rows;
  if (kSharedRows) {
    rows.lo = shared_rows + warp * stride;
    rows.hi = rows.lo + kChainWarps * stride;
  } else {
    rows.lo = work_lo + (p - p0) * lx;
    rows.hi = work_hi + (p - p0) * lx;
  }
  Problem q{};
  Chain ch{};
  bool chained = false, short_pair = false;
  if (p < p1) {
    q = load_problem(reads, lx, ly, idx_ref, idx_alt, per_read, keys, pos,
                     hap_len, p);
    short_pair = q.len_x > 0 && q.len_y > 0 && (q.len_x < kK || q.len_y < kK);
    chained = !short_pair && ends[p] != (p ? ends[p - 1] : 0);
    if (chained) {
      ch = chain_dp<Key>(q, ends, p, p0, match_i, match_j, match_prev,
                         rings[warp]);
    }
  }
  // -- the chain DP ends here --
  if (chained) chain_fill(ch, rings[warp], q.len_x, q.len_y, rows);
  // a row's bounds: its band, the full row of a short pair, else [0, 0)
  auto bounds = [&](int r, int& lo, int& hi) {
    lo = hi = 0;
    if (r < q.len_x) {
      if (chained && rows.lo[r] < rows.hi[r]) {
        lo = rows.lo[r];
        hi = rows.hi[r];
      } else if (short_pair) {
        hi = q.len_y;
      }
    }
  };
  if (kSharedRows) {
    for (int r = lane; r < lx; r += 32) {
      int lo, hi;
      bounds(r, lo, hi);
      rows.lo[r] = lo;
      rows.hi[r] = hi;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < lx * kChainWarps; k += kChainThreads) {
      const int r = k / kChainWarps, w = k % kChainWarps;
      if (first + w < p1) {
        jlo[r * n_prob + first + w] = shared_rows[w * stride + r];
        jhi[r * n_prob + first + w] =
            shared_rows[(kChainWarps + w) * stride + r];
      }
    }
  } else if (p < p1) {
    for (int r = lane; r < lx; r += 32) {
      int lo, hi;
      bounds(r, lo, hi);
      jlo[r * n_prob + p] = lo;
      jhi[r * n_prob + p] = hi;
    }
  }
}

unsigned warp_blocks(size_t n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// The k-mer index of a haplotype matrix on `stream`. haps: uint8 [n_haps,
// ly] (pad 1); keys: uint64 and pos: int32 [n_haps, ly], of which row h's
// first hap_len[h] - 5 entries are written (its 6-mer keys and positions,
// sorted by (key, j)); hap_len: int32 [n_haps], every row written. route
// 0: the shared route (tmp_keys, tmp_pos unread; refused past
// kSortMaxKeys keys a row, or where its shared memory does not fit a
// block); 1: the global route, tmp_keys, tmp_pos scratch of keys' and
// pos' shapes. Returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a route that cannot take the matrix.
int band_index_build(const void* haps, int n_haps, int ly, void* keys,
                     void* pos, void* tmp_keys, void* tmp_pos, void* hap_len,
                     int route, void* stream) {
  if (route != 0 && route != 1) return cudaErrorInvalidValue;
  const IndexShape shape = index_shape(ly);
  if (route == 0 && shape.sort == 0) return cudaErrorInvalidValue;
  if (route == 1 && (tmp_keys == nullptr || tmp_pos == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n_haps <= 0 || ly <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    index_kernel<<<n_haps, kIndexThreads, 0, s>>>(
        static_cast<const uint8_t*>(haps), ly,
        static_cast<unsigned long long*>(keys), static_cast<int32_t*>(pos),
        static_cast<unsigned long long*>(tmp_keys),
        static_cast<int32_t*>(tmp_pos), static_cast<int32_t*>(hap_len));
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = shape.rows > 1 ? index_shared_kernel<true>
                               : index_shared_kernel<false>;
  if (shape.smem + sizeof(int) > 48 * 1024) {
    int device = 0, limit = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    if (shape.smem + sizeof(int) > static_cast<size_t>(limit)) {
      return cudaErrorInvalidValue;
    }
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(shape.smem));
  }
  const unsigned blocks =
      static_cast<unsigned>((n_haps + shape.rows - 1) / shape.rows);
  kernel<<<blocks, shape.group * shape.rows, shape.smem, s>>>(
      static_cast<const uint8_t*>(haps), n_haps, ly, shape.group, shape.rows,
      static_cast<unsigned long long*>(keys), static_cast<int32_t*>(pos),
      static_cast<int32_t*>(hap_len));
  return static_cast<int>(cudaGetLastError());
}

// First half of a band build on `stream`: each problem's match count, from
// the index of band_index_build. reads: uint8 [n_reads, lx]; idx_ref,
// idx_alt: int32 [n_reads] (idx_alt unread when per_read == 1); per_read:
// 2 (problem p: read p/2 against idx_ref, p even, or idx_alt, p odd) or 1
// (problem p: read p against idx_ref[p]); keys, pos: [*, ly] and hap_len:
// int32 [*], the index; counts: int64 [per_read * n_reads]. Returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for another
// per_read.
int band_build_count(const void* reads, int n_reads, int lx, int ly,
                     const void* idx_ref, const void* idx_alt, int per_read,
                     const void* keys, const void* pos, const void* hap_len,
                     void* counts, void* stream) {
  if (per_read != 1 && per_read != 2) return cudaErrorInvalidValue;
  const size_t n_prob = per_read * static_cast<size_t>(n_reads);
  if (n_prob > 0) {
    count_kernel<<<warp_blocks(n_prob), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), n_prob, lx, ly,
        static_cast<const int32_t*>(idx_ref),
        static_cast<const int32_t*>(idx_alt), per_read,
        static_cast<const unsigned long long*>(keys),
        static_cast<const int32_t*>(pos),
        static_cast<const int32_t*>(hap_len), static_cast<long long*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}

// Second half, for problems [p0, p1): the chain DP and the band fill.
// Problems and per_read as band_build_count; ends: int64 [per_read *
// n_reads], the inclusive running sum of counts; match_i, match_j,
// match_prev: int32 [ends[p1 - 1] - ends[p0 - 1]] each (ends[-1] = 0), the
// range's matches; work_lo, work_hi: int32 [p1 - p0, lx], or both null:
// the band rows kept in shared memory (64 bytes per read row, which must
// fit a block's shared memory); jlo, jhi: int32 [lx, per_read * n_reads],
// one column per problem. wide_keys: 64-bit chain keys (needed from lx >=
// 2^25). Returns cudaGetLastError() (0 = ok), or cudaErrorInvalidValue.
int band_build_chain(const void* reads, int n_reads, int lx, int ly,
                     const void* idx_ref, const void* idx_alt, int per_read,
                     const void* keys, const void* pos, const void* hap_len,
                     const void* ends, long long p0, long long p1,
                     void* match_i, void* match_j, void* match_prev,
                     void* work_lo, void* work_hi, void* jlo, void* jhi,
                     int wide_keys, void* stream) {
  if (per_read != 1 && per_read != 2) return cudaErrorInvalidValue;
  const size_t n_prob = per_read * static_cast<size_t>(n_reads);
  if (p0 < 0 || p1 > static_cast<long long>(n_prob)) {
    return cudaErrorInvalidValue;
  }
  const bool shared = work_lo == nullptr;
  if (shared != (work_hi == nullptr)) return cudaErrorInvalidValue;
  const size_t smem =
      shared ? 2 * kChainWarps * sizeof(int32_t) * shared_stride(lx) : 0;
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem + sizeof(Ring) * kChainWarps > static_cast<size_t>(limit)) {
    return cudaErrorInvalidValue;
  }
  if (p0 >= p1) return 0;
  auto launch = [&](auto kernel) {
    if (smem + sizeof(Ring) * kChainWarps > 48 * 1024) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    const unsigned blocks = static_cast<unsigned>(
        (p1 - p0 + kChainWarps - 1) / kChainWarps);
    kernel<<<blocks, kChainThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), n_prob, lx, ly,
        static_cast<const int32_t*>(idx_ref),
        static_cast<const int32_t*>(idx_alt), per_read,
        static_cast<const unsigned long long*>(keys),
        static_cast<const int32_t*>(pos),
        static_cast<const int32_t*>(hap_len),
        static_cast<const long long*>(ends), p0, p1,
        static_cast<int32_t*>(match_i), static_cast<int32_t*>(match_j),
        static_cast<int32_t*>(match_prev), static_cast<int32_t*>(work_lo),
        static_cast<int32_t*>(work_hi), static_cast<int32_t*>(jlo),
        static_cast<int32_t*>(jhi));
  };
  if (wide_keys) {
    launch(shared ? chain_kernel<long long, true>
                  : chain_kernel<long long, false>);
  } else {
    launch(shared ? chain_kernel<int, true> : chain_kernel<int, false>);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* band_build_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
