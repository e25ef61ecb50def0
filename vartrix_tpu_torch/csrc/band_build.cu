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
//   1. index_kernel: one block per haplotype row: its true length, then its
//      len_y - 5 6-mer keys sorted by (key, j): every row is cut into runs
//      of one key, then runs of 2, 4, ... are merged in global memory (each
//      element finds its place by a binary search in the other run; on
//      equal keys the left run's elements, of smaller j, go first), so the
//      matches of one read 6-mer are one run of the sorted keys, ascending
//      in j. Pad rows (len_y = 0) stop after the length scan;
//   2. count_kernel: one warp per problem; each lane takes one read
//      position, looks its key up (two binary searches) and adds the run's
//      length. The wrapper sums the counts on the card (torch.cumsum) and
//      reads the total once, so the match scratch is sized exactly: a
//      repetitive pair may have (len_x - 5)(len_y - 5) matches, and the
//      traceback needs every match's predecessor. Where all of a launch's
//      matches would not fit the wrapper's scratch budget, it reads every
//      problem's sum, cuts the problems into ranges that fit and runs the
//      chain pass once per range;
//   3. chain_kernel: one warp per problem of a range looks up the runs of
//      32 read positions at once, then walks i in order and each run's j in
//      order, so the matches come in (i, j) order, and runs the chain DP as
//      it goes: the last 64 matches live in a ring of registers, two slots
//      per lane, so each lane scores two candidate predecessors and one
//      __reduce_max_sync over (score, nearness) keys applies the tie rules.
//      Lane 0 stores each match and its distance to its predecessor; the
//      warp then walks the best chain back, widening each anchor over a
//      problem-major work buffer [problem][row] (coalesced across lanes),
//      and writes the bounds in the DP's [row][problem] layout.
//
// Widths. A chain score is at most len_x, so its key (score x 64 +
// nearness) fits int32 while lx < 2^25; past that the wrapper launches the
// instantiation with 64-bit keys (two 32-bit warp reductions per match).
// Match indices and scratch offsets are 64-bit; the ring addresses its
// slots with a 32-bit index that steps back by 2^30 every 2^30 matches, and
// a predecessor is stored as its distance (1..64), so no per-match value
// passes 2^31.
//
// Bound. The bytes are small (reads, haplotypes and indices in, 8 bytes of
// bounds per read row and problem out); the work is integer instructions:
// len_x - 5 key lookups per problem plus, per match, its up to 64 chain
// candidates at the cost of scoring one (`candidate` and one max), at the
// instruction issue rate (chip_smoke.py prints both, and this kernel's own
// SASS instructions per candidate beside them). The index takes the
// all-pairs scans out of both passes; the chain DP's warp-wide step per
// match (~2.4x the bound's instructions per candidate: the reduction,
// the ring upkeep and the stores) is what remains between this kernel
// and its bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 6;         // k-mer length of the seeds
constexpr int kW = 20;        // half-width of the band around an anchor
constexpr int kMaxPred = 64;  // matches before each match the DP visits
constexpr int kMatch = 1;
constexpr int kGapOpen = -5;
constexpr int kGapExtend = -1;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kIndexThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRebase = 1 << 30;  // ring index step-back

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
// read position i (none when i >= n_i).
__device__ __forceinline__ void lookup(const Problem& q, int i, int n_i,
                                       int n_j, int& lo, int& hi) {
  lo = hi = 0;
  if (i < n_i) {
    const unsigned long long kx = kmer_key(q.x + i);
    lo = search<false>(q.keys, n_j, kx);
    hi = lo + search<true>(q.keys + lo, n_j - lo, kx);
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

// A ring slot: one of the last 64 matches (ring index b, -1 for none yet).
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

template <typename Key>
__global__ void __launch_bounds__(kThreads)
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
  const size_t p = p0 + static_cast<size_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
  if (p >= p1) return;
  const int lane = threadIdx.x & 31;
  const Problem q = load_problem(reads, lx, ly, idx_ref, idx_alt, per_read,
                                 keys, pos, hap_len, p);
  const int len_x = q.len_x, len_y = q.len_y;
  const long long start = p ? ends[p - 1] : 0;
  const long long count = ends[p] - start;
  const long long off = start - (p0 ? ends[p0 - 1] : 0);  // in the range
  const bool short_pair = len_x > 0 && len_y > 0 && (len_x < kK || len_y < kK);
  if (short_pair || count == 0) {  // full band, or no band at all
    for (int r = lane; r < lx; r += 32) {
      const bool full = short_pair && r < len_x;
      jlo[r * n_prob + p] = 0;
      jhi[r * n_prob + p] = full ? len_y : 0;
    }
    return;
  }
  int32_t* mi = match_i + off;
  int32_t* mj = match_j + off;
  int32_t* mp = match_prev + off;
  // chain DP, match by match in (i, j) order; a: the match's index in the
  // problem, ar: its ring index
  Slot s0{0, 0, 0, -1}, s1{0, 0, 0, -1};  // matches ar - 1 - lane (mod 64)
  int best_sc = -1, ar = 0;
  long long best_a = 0, a = 0;
  const int n_i = len_x - kK + 1, n_j = len_y - kK + 1;
  for (int i0 = 0; i0 < n_i; i0 += 32) {
    int run_lo, run_hi;
    lookup(q, i0 + lane, n_i, n_j, run_lo, run_hi);
    const int nt = min(32, n_i - i0);
    for (int t = 0; t < nt; ++t) {
      const int i = i0 + t;
      const int e1 = __shfl_sync(kFull, run_hi, t);
      for (int e = __shfl_sync(kFull, run_lo, t); e < e1; ++e) {
        const int j = __ldg(q.pos + e);
        if (ar == kRebase + kMaxPred) {  // every slot holds b >= kRebase
          ar -= kRebase;
          s0.b -= kRebase;
          s1.b -= kRebase;
        }
        Key key = max(candidate<Key>(s0, ar, i, j),
                      candidate<Key>(s1, ar, i, j));
        key = warp_max(key);
        const int sc = key ? static_cast<int>(key / kMaxPred) : kK * kMatch;
        if (lane == 0) {
          mi[a] = i;
          mj[a] = j;
          mp[a] = key ? kMaxPred - static_cast<int>(key % kMaxPred) : 0;
        }
        if (sc > best_sc) {
          best_sc = sc;
          best_a = a;
        }
        if (lane == (ar & 31)) {
          const Slot s{i, j, sc, ar};
          if (ar & 32) {
            s1 = s;
          } else {
            s0 = s;
          }
        }
        ++a;
        ++ar;
      }
    }
  }
  __syncwarp();
  // band fill over this problem's rows of the work buffer
  int32_t* wlo = work_lo + (p - p0) * lx;
  int32_t* whi = work_hi + (p - p0) * lx;
  for (int r = lane; r < len_x; r += 32) {
    wlo[r] = INT32_MAX;
    whi[r] = INT32_MIN;
  }
  __syncwarp();
  auto add_diag = [&](int i0, int j0, int len) {
    const int t0 = max(-kW, -i0), t1 = min(len + kW, len_x - i0);
    for (int t = t0 + lane; t < t1; t += 32) {
      const int r = i0 + t;
      wlo[r] = min(wlo[r], max(0, j0 + t - kW));
      whi[r] = max(whi[r], min(len_y, j0 + t + kW + 1));
    }
    __syncwarp();
  };
  auto add_box = [&](int i0, int i1, int j0, int j1) {
    i1 = min(len_x, i1);
    j0 = max(0, j0);
    j1 = min(len_y, j1);
    for (int r = max(0, i0) + lane; r < i1; r += 32) {
      wlo[r] = min(wlo[r], j0);
      whi[r] = max(whi[r], j1);
    }
    __syncwarp();
  };
  const int back_i = mi[best_a], back_j = mj[best_a];
  int front_i = back_i, front_j = back_j;
  for (long long c = best_a; c != -1;) {
    const int ci = mi[c], cj = mj[c], d = mp[c];
    const long long b = d ? c - d : -1;
    add_diag(ci, cj, kK);
    if (b != -1) add_box(mi[b], ci + kK, mj[b], cj + kK);
    front_i = ci;
    front_j = cj;
    c = b;
  }
  // corner extensions along the chain's end diagonals
  const int back = min(front_i, front_j);
  add_diag(front_i - back, front_j - back, back);
  const int i1 = back_i + kK, j1 = back_j + kK;
  add_diag(i1, j1, min(len_x - i1, len_y - j1));
  for (int r = lane; r < lx; r += 32) {
    int lo = 0, hi = 0;
    if (r < len_x && wlo[r] < whi[r]) {
      lo = wlo[r];
      hi = whi[r];
    }
    jlo[r * n_prob + p] = lo;
    jhi[r * n_prob + p] = hi;
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
// sorted by (key, j)); tmp_keys, tmp_pos: scratch of the same shapes;
// hap_len: int32 [n_haps]. Returns cudaGetLastError() (0 = ok).
int band_index_build(const void* haps, int n_haps, int ly, void* keys,
                     void* pos, void* tmp_keys, void* tmp_pos, void* hap_len,
                     void* stream) {
  if (n_haps > 0 && ly > 0) {
    index_kernel<<<n_haps, kIndexThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(haps), ly,
        static_cast<unsigned long long*>(keys), static_cast<int32_t*>(pos),
        static_cast<unsigned long long*>(tmp_keys),
        static_cast<int32_t*>(tmp_pos), static_cast<int32_t*>(hap_len));
  }
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
// range's matches; work_lo, work_hi: int32 [p1 - p0, lx]; jlo, jhi: int32
// [lx, per_read * n_reads], one column per problem. wide_keys: 64-bit
// chain keys (needed from lx >= 2^25). Returns cudaGetLastError() (0 =
// ok).
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
  if (p0 >= p1) return 0;
  auto launch = [&](auto kernel) {
    kernel<<<warp_blocks(p1 - p0), kThreads, 0,
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
    launch(chain_kernel<long long>);
  } else {
    launch(chain_kernel<int>);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* band_build_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
