// Banded affine-gap local Smith-Waterman scores of (read, haplotype)
// problems, one problem per thread, for Hopper (sm_90a): the DP of
// --sw-mode banded.
//
// Replaces the TPU kernel of that path, vartrix_tpu/ops/sw_pallas_v2.py:1836
// `_sw_kernel_v4_banded` (entry `_sw_banded_pairs`, l.1907): the full
// anti-diagonal DP with every cell masked by its read row's band. Each read
// row i carries one column interval [jlo[i], jhi[i]) built on the card by
// csrc/band_build.cu (the reference tool's chained k-mer band). Cells in
// the band follow the recurrence of csrc/sw_pair.cu:
//   E[i][j] = max(H[i][j-1] - 6, E[i][j-1] - 1)
//   F[i][j] = max(H[i-1][j] - 6, F[i-1][j] - 1)
//   H[i][j] = max(H[i-1][j-1] + s(x[i], y[j]), E, F, 0)
// and cells out of the band read H = 0, E = NEG, F = NEG, the boundary of
// the native banded aligner (native/swlib.cpp banded_sw_chained). Any E or
// F <= -5 acts as NEG (the next cell's gap then opens from H >= 0), so the
// kernel stores -6 for both. Bytes compare raw; reads pad with 0 and
// haplotypes with 1. With `codes` set, the ref and alt scores of each read
// reduce to one int8 call code (0/1/2/3, MIN_SCORE 25) as in sw_pair.cu.
//
// Layout, carried from sw_pair.cu. A thread sweeps the haplotype once per
// strip of kStrip = 8 read rows (16-row strips visit more out-of-band
// cells and measured slower at the main shape), holding the strip's read
// bases, per-row H and E, and the rows' bounds in registers; the bottom
// row's (H, F + 6) of each column goes to the next strip through global
// scratch, one 32-bit word of two 16-bit halves while min(lx, ly) < 65536
// (0 <= H, F + 6 <= min(lx, ly)) and past that a 64-bit one (the kWide
// instantiation, picked by the wrapper from (lx, ly)). The wrapper bounds
// the scratch (2 ly words per problem) with a budget and launches over
// ranges of reads that fit it. The
// K4 layout (128 lanes per diagonal, the reversed y buffer) hid the TPU's
// wavefront ramp and is not carried over.
//
// Scratch is indexed by the column's offset from the strip's first
// column, [j - c0][problem], not by the column itself: the lanes of a warp
// hold problems whose bands start at different columns, and at the same
// step they then touch neighbouring words instead of 32 rows of the
// buffer. Two buffers alternate by strip, since a strip reads its
// predecessor's words at offsets from that strip's first column.
//
// What the band buys. A strip visits the columns [c0, c1) of its rows'
// union (strips with no in-band row are skipped), in three zones:
//   * the core [max jlo, min jhi) over the strip's rows below the read's
//     true length, where every row is in band: sw_pair.cu's hot loop, with
//     no band test and no select;
//   * the entry zone [c0, core) and the exit zone [core, c1) on either
//     side, where each cell is masked by its own row's interval.
// Rows at or past the read's true length (read byte 0, which matches no
// haplotype byte) are computed freely in the core: their H never exceeds
// the best H of the rows above, and no live row lies below them. A strip
// may reach columns the strip above never visited: the previous strip's
// visited range stays in two registers and outside it the strip reads
// the word 0, (H, F) = (0, NEG), so scratch is never cleared. The row scan
// starts at c0 with H = 0 and E = NEG on its left, exact because that
// column is left of every row's band. Bounds load per strip from a
// [row][problem] layout, so a warp's 32 loads of one row coalesce.
//
// Bound. Like sw_pair.cu the work is integer instructions, bounded by
// instruction issue (4 warp instructions per SM and clock): the in-band
// cells at the recurrence's own cost per cell, that of sw_pair.cu's hot
// loop. The entry and exit zones (a diagonal band of width ~41 seen
// through an 8-row strip has ~7 masked columns on each side) and the
// out-of-band cells inside the strips' rectangles are the overhead;
// chip_smoke.py reads both loops' instructions per cell from cuobjdump
// -sass, and reports the visited and core cells. Lanes of a warp hold
// problems with different column ranges, so a warp runs as long as its
// widest lane in each strip (chip_smoke.py reports the idle lane slots).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMatch = 1;
constexpr int kMismatch = -5;
constexpr int kGapOpenExtend = -6;  // GAP_OPEN + GAP_EXTEND: a 1-base gap
constexpr int kGapExtend = -1;
constexpr int kMinScore = 25;       // both scores below: read dropped
constexpr int kNeg = -6;            // "no gap": any value <= -5 is exact
constexpr int kThreads = 128;
constexpr int kStrip = 8;           // read rows per strip

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

// Columns [j0, j1) of one strip. kMasked: each cell is tested against its
// row's band and set to (H, F) = (0, NEG) outside it; else every cell is
// computed as in sw_pair.cu. E needs no select: left of a row's band every
// H of the row is 0, so E stays at NEG (-6) there; right of it E is wrong
// but feeds only the row's cells further right, all out of band.
template <bool kMasked, bool kWide>
__device__ __forceinline__ void sweep(
    int j0, int j1, const int (&lo)[kStrip], const int (&hi)[kStrip],
    const int (&xs)[kStrip], int (&hl)[kStrip], int (&e)[kStrip],
    int& h_up_prev,
    int& best, const uint8_t* __restrict__ hrow,
    const typename Word<kWide>::T* __restrict__ col_in,
    typename Word<kWide>::T* __restrict__ col_out,
    size_t stride, int pv_lo, int pv_hi, int c0, bool last) {
  using W = typename Word<kWide>::T;
  constexpr int kShift = Word<kWide>::kShift;
  constexpr W kMask = (W(1) << kShift) - 1;
  // running offsets of column j in the two buffers (one add per column)
  const ptrdiff_t step = static_cast<ptrdiff_t>(stride);
  ptrdiff_t in = (j0 - pv_lo) * step, out = (j0 - c0) * step;
  for (int j = j0; j < j1; ++j, in += step, out += step) {
    const int yj = __ldg(hrow + j);
    const W w = j >= pv_lo && j < pv_hi ? col_in[in] : W(0);
    int h = static_cast<int>(w & kMask);                     // H[i0-1][j]
    int f = static_cast<int>(w >> kShift) + kGapOpenExtend;  // F[i0-1][j]
    int diag = h_up_prev;
    h_up_prev = h;
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      f = __viaddmax_s32(h, kGapOpenExtend, f + kGapExtend);
      const int en = __viaddmax_s32(hl[r], kGapOpenExtend, e[r] + kGapExtend);
      const int sc = xs[r] == yj ? kMatch : kMismatch;
      h = __vimax3_s32_relu(diag + sc, en, f);
      if (kMasked) {
        const bool in_band = j >= lo[r] && j < hi[r];
        h = in_band ? h : 0;
        f = in_band ? f : kNeg;
      }
      e[r] = en;
      diag = hl[r];
      hl[r] = h;
      best = max(best, h);
    }
    if (!last) {
      col_out[out] = (static_cast<W>(f - kGapOpenExtend) << kShift) |
                     static_cast<W>(h);
    }
  }
}

// Best banded local score of one read (row, lx bytes) against one
// haplotype (hrow, ly bytes). lo, hi: this problem's bounds of row 0, rows
// `bound_stride` apart; col: its scratch column, offsets `stride` apart,
// two buffers of ly offsets each.
template <bool kWide>
__device__ int sw_banded_problem(const uint8_t* __restrict__ row, int lx,
                                 const uint8_t* __restrict__ hrow, int ly,
                                 const int32_t* __restrict__ lo_ptr,
                                 const int32_t* __restrict__ hi_ptr,
                                 size_t bound_stride,
                                 typename Word<kWide>::T* __restrict__ col,
                                 size_t stride) {
  using W = typename Word<kWide>::T;
  int len_x = lx;
  while (len_x > 0 && __ldg(row + len_x - 1) == 0) --len_x;
  int best = 0;
  int pv_lo = 0, pv_hi = 0;  // columns the strip above visited
  const int n_strips = (lx + kStrip - 1) / kStrip;
  for (int s = 0; s < n_strips; ++s) {
    int lo[kStrip], hi[kStrip];
    int c0 = ly, c1 = 0, core_lo = 0, core_hi = ly;
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      const int i = s * kStrip + r;
      lo[r] = 0;
      hi[r] = 0;
      if (i < lx) {
        lo[r] = __ldg(lo_ptr + i * bound_stride);
        hi[r] = __ldg(hi_ptr + i * bound_stride);
      }
      if (lo[r] < hi[r]) {
        c0 = min(c0, lo[r]);
        c1 = max(c1, hi[r]);
      }
      if (i < len_x) {
        core_lo = max(core_lo, lo[r]);
        core_hi = min(core_hi, hi[r]);
      }
    }
    c0 = max(c0, 0);
    c1 = min(c1, ly);
    if (c0 >= c1) {  // no cell of the strip in the band
      pv_lo = pv_hi = 0;
      continue;
    }
    const int a = max(c0, min(core_lo, c1));  // [a, b): the core
    const int b = max(a, min(core_hi, c1));
    int xs[kStrip], hl[kStrip], e[kStrip];
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      const int i = s * kStrip + r;
      xs[r] = i < lx ? __ldg(row + i) : 0;
      hl[r] = 0;   // H left of the strip's first column
      e[r] = kNeg;
    }
    const bool last = s == n_strips - 1;
    const W* col_in = col + ((s + 1) & 1) * ly * stride;
    W* col_out = col + (s & 1) * ly * stride;
    int h_up_prev = 0;  // H[i0-1][c0-1]
    if (c0 > 0 && c0 - 1 >= pv_lo && c0 - 1 < pv_hi) {
      h_up_prev = static_cast<int>(col_in[(c0 - 1 - pv_lo) * stride] &
                                   ((W(1) << Word<kWide>::kShift) - 1));
    }
    sweep<true, kWide>(c0, a, lo, hi, xs, hl, e, h_up_prev, best, hrow,
                       col_in, col_out, stride, pv_lo, pv_hi, c0, last);
    sweep<false, kWide>(a, b, lo, hi, xs, hl, e, h_up_prev, best, hrow,
                        col_in, col_out, stride, pv_lo, pv_hi, c0, last);
    sweep<true, kWide>(b, c1, lo, hi, xs, hl, e, h_up_prev, best, hrow,
                       col_in, col_out, stride, pv_lo, pv_hi, c0, last);
    pv_lo = c0;
    pv_hi = c1;
  }
  return best;
}

// Problem p scores read p/2 against idx_ref (p even) or idx_alt (p odd);
// its bounds are column p of jlo/jhi, rows bound_stride apart.
// kCodes: one int8 call code per read, else int32 scores
// [2][score_stride] (columns [0, n_reads) written).
template <bool kCodes, bool kWide>
__global__ void __launch_bounds__(kThreads)
sw_banded_kernel(const uint8_t* __restrict__ reads, int n_reads, int lx,
                 const uint8_t* __restrict__ haps, int ly,
                 const int32_t* __restrict__ idx_ref,
                 const int32_t* __restrict__ idx_alt,
                 const int32_t* __restrict__ jlo,
                 const int32_t* __restrict__ jhi, size_t bound_stride,
                 int32_t* __restrict__ scores, int score_stride,
                 int8_t* __restrict__ codes,
                 typename Word<kWide>::T* __restrict__ scratch) {
  const size_t n_prob = 2 * static_cast<size_t>(n_reads);
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = p < n_prob;
  const int read = live ? static_cast<int>(p >> 1) : 0;
  const int which = static_cast<int>(p & 1);
  int best = 0;
  if (live) {
    const int hidx = __ldg((which ? idx_alt : idx_ref) + read);
    best = sw_banded_problem<kWide>(
        reads + static_cast<size_t>(read) * lx, lx,
        haps + static_cast<size_t>(hidx) * ly, ly, jlo + p, jhi + p,
        bound_stride, scratch + p, n_prob);
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

template <bool kCodes, bool kWide>
void launch(unsigned blocks, cudaStream_t stream, const uint8_t* reads,
            int n_reads, int lx, const uint8_t* haps, int ly,
            const int32_t* idx_ref, const int32_t* idx_alt,
            const int32_t* jlo, const int32_t* jhi, size_t bound_stride,
            int32_t* scores, int score_stride, int8_t* codes,
            void* scratch) {
  sw_banded_kernel<kCodes, kWide><<<blocks, kThreads, 0, stream>>>(
      reads, n_reads, lx, haps, ly, idx_ref, idx_alt, jlo, jhi, bound_stride,
      scores, score_stride, codes,
      static_cast<typename Word<kWide>::T*>(scratch));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// reads: uint8 [n_reads, lx]; haps: uint8 [*, ly]; jlo, jhi: int32 [lx,
// bound_stride], problem p's bounds in column p (p < 2 n_reads). Exactly
// one of scores (int32 [2, score_stride], columns [0, n_reads) written)
// and codes (int8 [n_reads]) is non-null. scratch: [2 ly, 2 n_reads]
// words, uint32 or, with wide, uint64; none needed when lx <= 8 (one
// strip). wide is needed from min(lx, ly) >= 65536.
int sw_banded_launch(const void* reads, int n_reads, int lx, const void* haps,
                     int ly, const void* idx_ref, const void* idx_alt,
                     const void* jlo, const void* jhi, long long bound_stride,
                     void* scores, int score_stride, void* codes,
                     void* scratch, int wide, void* stream) {
  const size_t n_prob = 2 * static_cast<size_t>(n_reads);
  if (n_prob == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_prob + kThreads - 1) / kThreads);
  auto* go = codes ? (wide ? &launch<true, true> : &launch<true, false>)
                   : (wide ? &launch<false, true> : &launch<false, false>);
  go(blocks, static_cast<cudaStream_t>(stream),
     static_cast<const uint8_t*>(reads), n_reads, lx,
     static_cast<const uint8_t*>(haps), ly,
     static_cast<const int32_t*>(idx_ref),
     static_cast<const int32_t*>(idx_alt), static_cast<const int32_t*>(jlo),
     static_cast<const int32_t*>(jhi), static_cast<size_t>(bound_stride),
     static_cast<int32_t*>(scores), score_stride,
     static_cast<int8_t*>(codes), scratch);
  return static_cast<int>(cudaGetLastError());
}

const char* sw_banded_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
