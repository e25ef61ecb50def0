// Exact affine-gap local Smith-Waterman scores of (read, haplotype)
// problems for Hopper (sm_90a): two problems per thread in the 16-bit
// halves of 32-bit words, computed with the 16x2 DPX instructions.
//
// Replaces the TPU kernels of the full-SW path, which all compute this one
// function (vartrix_tpu/ops/):
//   K1 sw_pallas_v2.py _sw_kernel_v4  one (read, hap) pair per lane;
//   K2 sw_pallas_v2.py _sw_kernel_v5  one read against ref ++ alt chained;
//   K3 sw_pallas_v2.py _sw_kernel_v6  two reads per lane against r1ref ++
//      r1alt ++ r2ref ++ r2alt (the production kernel);
//   K5 sw_pallas_v2.py _sw_kernel_v7  reads chained over interleaved idx2
//      (here idx_ref = idx2[0::2], idx_alt = idx2[1::2]);
//   K6 sw_pallas.py _sw_kernel        plain (x, y) rows (per_read == 1).
// The chaining and the 128-lane layout only recover wavefront ramp waste on
// the TPU. Here a thread sweeps its problems' haplotype columns itself and
// stops at their true lengths. The device glue of the jitted entries is
// fused into the load and store stages: the 2-bit and 4-bit read unpacks
// (_unpack2, and _unpack4 of K3's 4-bit entries _sw_pair_quad_calls_packed
// and _packed2), the gather of haplotype rows by index, and the reduction
// of each read's (ref, alt) scores to one int8 call code.
//
// Three read formats (ReadFormat), each a template instantiation: dense
// bytes (pad 0; a read's length is its last non-zero byte), 2-bit A/C/G/T
// codes and 4-bit BAM nibble codes of "=ACMGRSVTWYHKDBN" (both with their
// lengths). A packed base is unpacked where the strip loads its read rows,
// once per read row and strip, outside the column loop: no dense copy of
// the reads is written.
//
// Recurrence (Gotoh, same as ops/sw_torch.py and the reference's NumPy
// oracle): MATCH +1, MISMATCH -5, a gap of length L costs -5 - L.
//   E[i][j] = max(H[i][j-1] - 6, E[i][j-1] - 1)      gap along the haplotype
//   F[i][j] = max(H[i-1][j] - 6, F[i-1][j] - 1)      gap along the read
//   H[i][j] = max(H[i-1][j-1] + s(x[i], y[j]), E, F, 0)
// Bases compare as raw bytes. Reads pad with byte 0 and haplotypes with
// byte 1; pad never equals a base, so pad cells only lower a path's score.
// Once computed, 0 <= H <= min(len_x, len_y) and E, F >= -6; an H reaches
// its bound only by a match, at a cell inside both true lengths.
//
// Three routes; the wrapper picks one from (lx, ly) alone
// (ops/sw_cuda.pair_route):
//   packed  min(lx, ly) <= 32,767: two problems per thread, below;
//   word32  up to 65,535: one problem per thread, 32-bit scratch word;
//   word64  from 65,536: the same with a 64-bit scratch word (kWide).
// Past 32,767 an H no longer fits an int16 half. One problem per thread in
// 32-bit registers holds any H; its scratch word packs H and F + 6 as two
// 16-bit halves below 65,536 and as two 32-bit halves from there.
//
// Packed route. Thread k owns problems 2k and 2k + 1, low half and high
// half: a read's ref and alt (per_read == 2, so its int8 code is formed in
// the thread that holds both scores), or two plain rows (per_read == 1).
// Every value is a pair of int16 halves, combined only by the DPX forms,
// which add and compare per half: no borrow crosses halves, and no value
// wraps (the largest is H <= 32,767, the smallest kNeg - 6). A cell keeps
// G = H - 6, what both gaps and the next row's diagonal take:
//   E  = viaddmax(E, -1, G_left)               E[i][j]
//   q  = viaddmax(~(x ^ y), 8, 1)              7 on a match, else 1
//   T  = viaddmax_relu(G_diag, q, E)           max(H_diag + s, E, 0)
//   T6 = viaddmax(T, -6, -6)                   T - 6 (T >= 0)
//   G  = viaddmax(F, -6, T6)                   max(T, F) - 6 = H - 6
//   F  = viaddmax(F, -1, T6)                   F[i+1][j]
//   best = vimax3(best, G_r, G_r+1)            once per two rows
// Bases sit in each half shifted left by 3, so x ^ y is 0 on a match and
// at least 8 otherwise. The next row's F takes T6, not G:
// max(F - 1, T - 6, F - 6) = max(F - 1, T - 6), so the chain down a
// column is one instruction per row. The pair runs to the longer read and
// the longer haplotype of its two problems: the shorter one's pad bytes
// fill the extra cells, which only lower its paths.
//
// Layout. A thread sweeps the haplotype columns once per strip of read
// rows (kPackedStrip = 32 on the packed route, kStrip = 16 on the scalar
// ones). The strip's read words and per-row G and E (H and E) live in
// registers; F chains down the strip's column. Between strips the bottom
// row's words of each column go through a global scratch laid out
// [column][thread], so neighbouring threads touch neighbouring words:
// (G, F), 8 bytes per thread and column on the packed route, 4 bytes per
// problem as on word32. The packed loop takes kCols = 2 columns per step
// and loads the next step's haplotype and scratch words during this one,
// so no column waits out a memory round trip. The wrapper bounds the
// scratch with a budget and launches over ranges of reads that fit it.
//
// Bound. The work is integer instructions, and each SM issues at most 4
// warp instructions a clock, whatever pipe runs them. chip_smoke.py charges
// each needed cell the least update above, read from the SASS of a probe
// of its own (two packed cells per loop step, less the same loop with only
// its loads, over four): 3.75 instructions per problem cell, 3.25 of them
// DPX. The hot loop here (sm_90a; chip_smoke.py reads it with cuobjdump
// on every run) issues 577 instructions per step of 2 columns x 32 rows
// x 2 problems, 4.51 per problem cell against the scalar loop's 9.875:
// the update's 3.75 (320 add-maxes, 64 with zero, 32 three-way maxes, 64
// xnors), plus register moves, the loads, the scratch store and the
// loop's control. The 16x2 add-max and three-way max issue at about half
// the rate of the issue slots (chip_smoke.py measures 1.9 warp
// instructions per SM and clock), so the DPX pipe, not issue, bounds this
// loop first: at the main shape 3.25 DPX per cell take 0.78 ms, the
// issue bound 0.43 ms (PERF.md).
//
// Strip height and columns per step were measured at the main shape
// (lx = 160, ly = 224): 32 rows beat 16, 24 and 28; two columns beat one
// and four; capping registers at 128 for a fourth block per SM spills and
// is slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatch = 1;
constexpr int kMismatch = -5;
constexpr int kGapOpenExtend = -6;  // GAP_OPEN + GAP_EXTEND: a 1-base gap
constexpr int kGapExtend = -1;
constexpr int kMinScore = 25;       // both scores below: read dropped
constexpr int kNeg = -30000;        // "no gap yet"; any value <= -5 is exact
constexpr int kStrip = 16;          // read rows held in registers
constexpr int kThreads = 128;
constexpr int kPackedMax = 32767;   // the packed route: min(lx, ly) <= this
constexpr int kWord32Max = 65535;   // word32: min(lx, ly) <= this

enum Route { kPackedRoute = 0, kWord32Route = 1, kWord64Route = 2 };

// The read formats, by their code in sw_pair_launch.
enum ReadFormat { kDense = 0, kBits2 = 1, kBits4 = 2 };

// 'A', 'C', 'G', 'T' for 2-bit codes 0..3 (gio_gather_padded_packed2)
constexpr uint32_t kAcgt = 'A' | ('C' << 8) | ('G' << 16) | ('T' << 24);
// "=ACMGRSV" and "TWYHKDBN" for 4-bit codes 0..7 and 8..15, a byte each,
// lowest first (gio_gather_padded_packed, BAM's seq_nt16)
constexpr unsigned long long kNt16Lo = 0x565352474d43413dULL;
constexpr unsigned long long kNt16Hi = 0x4e42444b48595754ULL;

template <int kFormat>
__device__ __forceinline__ int read_base(const uint8_t* __restrict__ row,
                                         int i, int len) {
  if (i >= len) return 0;
  if (kFormat == kBits2) {
    const int code = (__ldg(row + (i >> 2)) >> ((i & 3) * 2)) & 3;
    return (kAcgt >> (code * 8)) & 0xff;
  }
  if (kFormat == kBits4) {
    const int code = (__ldg(row + (i >> 1)) >> (i & 1 ? 0 : 4)) & 15;
    const unsigned long long w = code & 8 ? kNt16Hi : kNt16Lo;
    return static_cast<int>((w >> ((code & 7) * 8)) & 0xff);
  }
  return __ldg(row + i);
}

// True length of a read: its length entry (packed formats) or its last
// non-pad byte.
template <int kFormat>
__device__ __forceinline__ int read_length(const uint8_t* __restrict__ row,
                                           const int32_t* __restrict__ lens,
                                           int read, int lx) {
  if (kFormat != kDense) return min(max(__ldg(lens + read), 0), lx);
  int n = lx;
  while (n > 0 && __ldg(row + n - 1) == 0) --n;
  return n;
}

// True length of a haplotype row: its last byte that is not the pad 1.
__device__ __forceinline__ int hap_length(const uint8_t* __restrict__ hrow,
                                          int ly) {
  int n = ly;
  while (n > 0 && __ldg(hrow + n - 1) == 1) --n;
  return n;
}

// ---------------------------------------------------------------- packed

// v in both int16 halves
constexpr uint32_t splat(int v) {
  return (static_cast<uint32_t>(v) & 0xffffu) * 0x00010001u;
}
constexpr uint32_t kP1 = splat(1), kP8 = splat(8), kPm1 = splat(-1);
constexpr uint32_t kPm6 = splat(kGapOpenExtend), kPNeg = splat(kNeg);

// The packed loop's second constants of q and T6: a DPX instruction takes
// at most one immediate, and a value the compiler cannot see stays in a
// register instead of being rebuilt before every use.
__device__ uint32_t gPackedConsts[2] = {kP8, kPm6};

// Read rows per strip of the packed loop.
constexpr int kPackedStrip = 32;

// Columns per step of the packed loop. A step's haplotype words and
// scratch words are loaded during the step before, so neither waits out a
// memory round trip; the columns of a step run branch-free, so the pair's
// columns are rounded up to a multiple of kCols (pad columns, whose cells
// only lower a path) and the scratch holds that many.
constexpr int kCols = 2;

// The haplotype word of column j: each half a haplotype byte shifted left
// by 3, the pad byte 1 from column n_y on.
__device__ __forceinline__ uint32_t hap_word(const uint8_t* __restrict__ h0,
                                             const uint8_t* __restrict__ h1,
                                             int j, int n_y) {
  const uint32_t b0 = j < n_y ? __ldg(h0 + j) : 1u;
  const uint32_t b1 = j < n_y ? __ldg(h1 + j) : 1u;
  return (b0 | (b1 << 16)) << 3;
}

// Best local scores, as G = H - 6 in the low and high half, of two problems:
// reads row0 / row1 (len0 / len1 bases; row1 == row0 when `shared`) against
// haplotype rows hrow0 / hrow1, over n_x read rows and n_y columns (the
// longer of each pair). col: this thread's scratch column, stride between
// haplotype positions (at least n_y rounded up to kCols of them).
template <int kFormat>
__device__ uint32_t sw_pair16x2(const uint8_t* __restrict__ row0, int len0,
                                const uint8_t* __restrict__ row1, int len1,
                                bool shared,
                                const uint8_t* __restrict__ hrow0,
                                const uint8_t* __restrict__ hrow1, int n_x,
                                int n_y, uint2* __restrict__ col,
                                size_t stride) {
  const uint32_t k8 = gPackedConsts[0], km6 = gPackedConsts[1];
  uint32_t best = kPm6;
  const int n_strips = (n_x + kPackedStrip - 1) / kPackedStrip;
  const int n_cols = (n_y + kCols - 1) / kCols * kCols;
  for (int s = 0; s < n_strips; ++s) {
    uint32_t xs[kPackedStrip], g[kPackedStrip], e[kPackedStrip];
#pragma unroll
    for (int r = 0; r < kPackedStrip; ++r) {
      const int i = s * kPackedStrip + r;
      const uint32_t b0 = read_base<kFormat>(row0, i, len0);
      const uint32_t b1 = shared ? b0 : read_base<kFormat>(row1, i, len1);
      xs[r] = (b0 | (b1 << 16)) << 3;
      g[r] = kPm6;   // H[i][-1] - 6
      e[r] = kPNeg;  // E[i][-1]
    }
    const bool first = s == 0;
    const bool last = s == n_strips - 1;
    uint32_t g_up_prev = kPm6;  // G[i0-1][j-1]
    // the next step's words: haplotype, and (G[i0-1][j], F[i0][j])
    uint32_t y_next[kCols];
    uint2 w_next[kCols];
#pragma unroll
    for (int d = 0; d < kCols; ++d) {
      y_next[d] = hap_word(hrow0, hrow1, d, n_y);
      w_next[d] = first ? make_uint2(kPm6, kPNeg) : col[d * stride];
    }
    for (int j0 = 0; j0 < n_cols; j0 += kCols) {
      uint32_t y[kCols];
      uint2 w[kCols];
#pragma unroll
      for (int d = 0; d < kCols; ++d) {
        y[d] = y_next[d];
        w[d] = w_next[d];
      }
      if (j0 + kCols < n_cols) {
#pragma unroll
        for (int d = 0; d < kCols; ++d) {
          const int j = j0 + kCols + d;
          y_next[d] = hap_word(hrow0, hrow1, j, n_y);
          if (!first) w_next[d] = col[j * stride];
        }
      }
#pragma unroll
      for (int d = 0; d < kCols; ++d) {
        uint32_t diag = g_up_prev;
        g_up_prev = w[d].x;
        uint32_t f = w[d].y;
#pragma unroll
        for (int r = 0; r < kPackedStrip; ++r) {
          e[r] = __viaddmax_s16x2(e[r], kPm1, g[r]);
          const uint32_t q = __viaddmax_s16x2(~(xs[r] ^ y[d]), k8, kP1);
          const uint32_t t = __viaddmax_s16x2_relu(diag, q, e[r]);
          const uint32_t t6 = __viaddmax_s16x2(t, km6, kPm6);
          diag = g[r];
          g[r] = __viaddmax_s16x2(f, kPm6, t6);
          f = __viaddmax_s16x2(f, kPm1, t6);
          if (r & 1) best = __vimax3_s16x2(best, g[r - 1], g[r]);
        }
        if (!last) {
          col[(j0 + d) * stride] = make_uint2(g[kPackedStrip - 1], f);
        }
      }
    }
  }
  return best;
}

__device__ __forceinline__ int low_score(uint32_t g) {
  return static_cast<int16_t>(g & 0xffffu) - kGapOpenExtend;
}
__device__ __forceinline__ int high_score(uint32_t g) {
  return static_cast<int16_t>(g >> 16) - kGapOpenExtend;
}

// per_read == 2: thread k scores read k against idx_ref (low half) and
// idx_alt (high half); per_read == 1: reads 2k and 2k + 1 against
// idx_ref[2k] and idx_ref[2k + 1] (an odd last read pairs with an empty
// problem). Outputs as sw_pair_kernel.
template <int kFormat, bool kCodes>
__global__ void __launch_bounds__(kThreads)
sw_pair16x2_kernel(const uint8_t* __restrict__ reads,
                   const int32_t* __restrict__ read_lens, int n_reads,
                   int lx, int row_bytes, const uint8_t* __restrict__ haps,
                   int ly, const int32_t* __restrict__ idx_ref,
                   const int32_t* __restrict__ idx_alt, int per_read,
                   int32_t* __restrict__ scores, int score_stride,
                   int8_t* __restrict__ codes, uint2* __restrict__ scratch) {
  const size_t n_prob = static_cast<size_t>(n_reads) * per_read;
  const size_t n_pairs = (n_prob + 1) / 2;
  const size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n_pairs) return;
  const bool shared = per_read == 2;
  const int read0 = static_cast<int>(shared ? k : 2 * k);
  const bool has1 = shared || 2 * k + 1 < n_prob;
  const int read1 = shared || !has1 ? read0 : read0 + 1;
  const uint8_t* row0 = reads + static_cast<size_t>(read0) * row_bytes;
  const uint8_t* row1 = reads + static_cast<size_t>(read1) * row_bytes;
  const int len0 = read_length<kFormat>(row0, read_lens, read0, lx);
  const int len1 = shared ? len0
                          : (has1 ? read_length<kFormat>(row1, read_lens,
                                                          read1, lx)
                                  : 0);
  const int h0 = __ldg(idx_ref + read0);
  const int h1 = shared ? __ldg(idx_alt + read0) : __ldg(idx_ref + read1);
  const uint8_t* hrow0 = haps + static_cast<size_t>(h0) * ly;
  const uint8_t* hrow1 = haps + static_cast<size_t>(h1) * ly;
  const int n_x = max(len0, len1);
  const int n_y = max(hap_length(hrow0, ly),
                      has1 ? hap_length(hrow1, ly) : 0);
  uint32_t best = kPm6;
  if (n_x > 0 && n_y > 0) {
    best = sw_pair16x2<kFormat>(row0, len0, row1, len1, shared, hrow0,
                                 hrow1, n_x, n_y, scratch + k, n_pairs);
  }
  const int s0 = low_score(best), s1 = high_score(best);
  if (kCodes) {
    int8_t code = s0 > s1 ? 1 : (s1 > s0 ? 2 : 3);
    if (s0 < kMinScore && s1 < kMinScore) code = 0;
    codes[read0] = code;
  } else if (shared) {
    scores[read0] = s0;
    scores[static_cast<size_t>(score_stride) + read0] = s1;
  } else {
    scores[read0] = s0;
    if (has1) scores[read1] = s1;
  }
}

// ---------------------------------------------------------------- scalar

// The scratch word of the bottom row's (H, F + 6): two 16-bit halves, or
// with kWide two 32-bit halves.
template <bool kWide>
struct Word {
  using T = uint32_t;
  static constexpr int kShift = 16;
};
template <>
struct Word<true> {
  using T = unsigned long long;
  static constexpr int kShift = 32;
};

// Scratch words the kWide instantiation loads ahead of the column that
// uses them. A problem that needs the wide word runs so long (4.6 G cells
// at 65,536 x 70,000) that its warp is often alone on its scheduler, where
// nothing else hides the L2 round trip of each column's word.
constexpr int kAhead = 4;

// Best local score of one read (row, len_x bases) against one haplotype
// (hrow, len_y bases). col: this problem's scratch column, stride between
// haplotype positions.
template <int kFormat, bool kWide>
__device__ int sw_problem(const uint8_t* __restrict__ row, int len_x,
                          const uint8_t* __restrict__ hrow, int len_y,
                          typename Word<kWide>::T* __restrict__ col,
                          size_t stride) {
  using W = typename Word<kWide>::T;
  constexpr int kShift = Word<kWide>::kShift;
  constexpr W kMask = (W(1) << kShift) - 1;
  int best = 0;
  const int n_strips = (len_x + kStrip - 1) / kStrip;
  for (int s = 0; s < n_strips; ++s) {
    int xs[kStrip], hl[kStrip], e[kStrip];
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      xs[r] = read_base<kFormat>(row, s * kStrip + r, len_x);
      hl[r] = 0;     // H[i][-1]
      e[r] = kNeg;   // E[i][-1]
    }
    const bool first = s == 0;
    const bool last = s == n_strips - 1;
    int h_up_prev = 0;  // H[i0-1][j-1]
    W ahead[kWide ? kAhead : 1];  // kWide: the words of columns j, j + 1, ..
    if (kWide && !first) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        ahead[d] = d < len_y ? col[d * stride] : W(0);
      }
    }
    for (int j = 0; j < len_y; ++j) {
      const int yj = __ldg(hrow + j);
      int h = 0, f = kNeg;  // H[i0-1][j], F[i0-1][j]
      if (!first) {
        W w;
        if constexpr (kWide) {
          w = ahead[0];
#pragma unroll
          for (int d = 0; d + 1 < kAhead; ++d) ahead[d] = ahead[d + 1];
          ahead[kAhead - 1] =
              j + kAhead < len_y ? col[(j + kAhead) * stride] : W(0);
        } else {
          w = col[j * stride];
        }
        h = static_cast<int>(w & kMask);
        f = static_cast<int>(w >> kShift) + kGapOpenExtend;
      }
      int diag = h_up_prev;
      h_up_prev = h;
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        f = __viaddmax_s32(h, kGapOpenExtend, f + kGapExtend);
        e[r] = __viaddmax_s32(hl[r], kGapOpenExtend, e[r] + kGapExtend);
        const int sc = xs[r] == yj ? kMatch : kMismatch;
        h = __vimax3_s32_relu(diag + sc, e[r], f);
        diag = hl[r];
        hl[r] = h;
        best = max(best, h);
      }
      if (!last) {
        col[j * stride] = (static_cast<W>(f - kGapOpenExtend) << kShift) |
                          static_cast<W>(h);
      }
    }
  }
  return best;
}

// per_read == 2: problem p scores read p/2 against idx_ref (p even) or
// idx_alt (p odd); per_read == 1: read p against idx_ref[p].
// kCodes (per_read == 2 only): one int8 call code per read, else int32
// scores [per_read][score_stride] (columns [0, n_reads) written).
template <int kFormat, bool kCodes, bool kWide>
__global__ void __launch_bounds__(kThreads)
sw_pair_kernel(const uint8_t* __restrict__ reads,
               const int32_t* __restrict__ read_lens, int n_reads, int lx,
               int row_bytes, const uint8_t* __restrict__ haps, int ly,
               const int32_t* __restrict__ idx_ref,
               const int32_t* __restrict__ idx_alt, int per_read,
               int32_t* __restrict__ scores, int score_stride,
               int8_t* __restrict__ codes,
               typename Word<kWide>::T* __restrict__ scratch) {
  const size_t n_prob = static_cast<size_t>(n_reads) * per_read;
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = p < n_prob;
  const int read = live ? static_cast<int>(per_read == 2 ? p >> 1 : p) : 0;
  const int which = per_read == 2 ? static_cast<int>(p & 1) : 0;
  int best = 0;
  if (live) {
    const uint8_t* row = reads + static_cast<size_t>(read) * row_bytes;
    const int len_x = read_length<kFormat>(row, read_lens, read, lx);
    const int hidx = __ldg((which ? idx_alt : idx_ref) + read);
    const uint8_t* hrow = haps + static_cast<size_t>(hidx) * ly;
    const int len_y = hap_length(hrow, ly);
    if (len_x > 0 && len_y > 0) {
      best = sw_problem<kFormat, kWide>(row, len_x, hrow, len_y,
                                         scratch + p, n_prob);
    }
  }
  if (kCodes) {
    // the pair (ref, alt) of one read sits in adjacent lanes of one warp
    const int other = __shfl_xor_sync(0xffffffffu, best, 1);
    if (live && which == 0) {
      const int ref = best, alt = other;
      int8_t code = ref > alt ? 1 : (alt > ref ? 2 : 3);
      if (ref < kMinScore && alt < kMinScore) code = 0;
      codes[read] = code;
    }
  } else if (live) {
    scores[static_cast<size_t>(which) * score_stride + read] = best;
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const uint8_t* reads;
  const int32_t* read_lens;
  int n_reads, lx, row_bytes;
  const uint8_t* haps;
  int ly;
  const int32_t* idx_ref;
  const int32_t* idx_alt;
  int per_read;
  int32_t* scores;
  int score_stride;
  int8_t* codes;
  void* scratch;
};

unsigned blocks_for(size_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <int kFormat, bool kCodes>
void launch_packed(const Args& a, cudaStream_t stream) {
  const size_t n_prob = static_cast<size_t>(a.n_reads) * a.per_read;
  sw_pair16x2_kernel<kFormat, kCodes>
      <<<blocks_for((n_prob + 1) / 2), kThreads, 0, stream>>>(
          a.reads, a.read_lens, a.n_reads, a.lx, a.row_bytes, a.haps, a.ly,
          a.idx_ref, a.idx_alt, a.per_read, a.scores, a.score_stride,
          a.codes, static_cast<uint2*>(a.scratch));
}

template <int kFormat, bool kCodes, bool kWide>
void launch_scalar(const Args& a, cudaStream_t stream) {
  const size_t n_prob = static_cast<size_t>(a.n_reads) * a.per_read;
  sw_pair_kernel<kFormat, kCodes, kWide>
      <<<blocks_for(n_prob), kThreads, 0, stream>>>(
          a.reads, a.read_lens, a.n_reads, a.lx, a.row_bytes, a.haps, a.ly,
          a.idx_ref, a.idx_alt, a.per_read, a.scores, a.score_stride,
          a.codes, static_cast<typename Word<kWide>::T*>(a.scratch));
}

template <int kFormat, bool kCodes>
void launch_route(int route, const Args& a, cudaStream_t stream) {
  if (route == kPackedRoute) {
    launch_packed<kFormat, kCodes>(a, stream);
  } else if (route == kWord32Route) {
    launch_scalar<kFormat, kCodes, false>(a, stream);
  } else {
    launch_scalar<kFormat, kCodes, true>(a, stream);
  }
}

template <int kFormat>
void launch_format(int route, const Args& a, cudaStream_t stream) {
  if (a.codes) {
    launch_route<kFormat, true>(route, a, stream);
  } else {
    launch_route<kFormat, false>(route, a, stream);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue when `route` cannot hold min(lx, ly) or
// `read_format` is none of ReadFormat.
// reads, by read_format: 0 uint8 [n_reads, lx]; 1 [n_reads, lx / 4] 2-bit
// codes; 2 [n_reads, lx / 2] 4-bit codes; the packed formats with int32
// read_lens [n_reads]. haps: uint8 [*, ly].
// Exactly one of scores (int32 [per_read, score_stride], columns [0,
// n_reads) written) and codes (int8 [n_reads], per_read = 2) is non-null.
// route: 0 packed (min(lx, ly) <= 32,767; scratch uint2 [ly rounded up to
// a multiple of 2, ceil(n_reads * per_read / 2)]), 1 word32 (<= 65,535;
// uint32 [ly, n_reads * per_read]), 2 word64 (any; uint64 [ly, n_reads *
// per_read]). No scratch is needed when the reads fit one strip: lx <= 32
// (packed) or 16 (word32, word64).
int sw_pair_launch(const void* reads, const void* read_lens, int n_reads,
                   int lx, int read_format, const void* haps, int ly,
                   const void* idx_ref, const void* idx_alt, int per_read,
                   void* scores, int score_stride, void* codes,
                   void* scratch, int route, void* stream) {
  const int width = min(lx, ly);
  if ((route == kPackedRoute && width > kPackedMax) ||
      (route == kWord32Route && width > kWord32Max) || route < kPackedRoute ||
      route > kWord64Route || read_format < kDense ||
      read_format > kBits4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<size_t>(n_reads) * per_read == 0) return 0;
  const Args a{static_cast<const uint8_t*>(reads),
               static_cast<const int32_t*>(read_lens), n_reads, lx,
               read_format == kBits2   ? lx / 4
               : read_format == kBits4 ? lx / 2
                                       : lx,
               static_cast<const uint8_t*>(haps), ly,
               static_cast<const int32_t*>(idx_ref),
               static_cast<const int32_t*>(idx_alt), per_read,
               static_cast<int32_t*>(scores), score_stride,
               static_cast<int8_t*>(codes), scratch};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (read_format == kBits2) {
    launch_format<kBits2>(route, a, st);
  } else if (read_format == kBits4) {
    launch_format<kBits4>(route, a, st);
  } else {
    launch_format<kDense>(route, a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sw_pair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
