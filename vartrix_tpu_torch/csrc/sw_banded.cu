// Banded affine-gap local Smith-Waterman scores of (read, haplotype)
// problems for Hopper (sm_90a): the DP of --sw-mode banded. Two problems
// per thread in the 16-bit halves of 32-bit words, computed with the 16x2
// DPX instructions, or past the halves' range one problem per thread.
//
// Replaces the TPU kernel of that path, vartrix_tpu/ops/sw_pallas_v2.py:1836
// `_sw_kernel_v4_banded` (entry `_sw_banded_pairs`, l.1907): the full
// anti-diagonal DP with every cell masked by its read row's band. Problems
// come in sw_pair.cu's two layouts: per_read == 2, a read's ref and alt
// (the native host path, which may fuse their scores into one call code);
// per_read == 1, read p against idx_ref[p], K4's own plain rows x [B, lx]
// against y [B, ly] (the Python host path). Each read row i carries one
// column interval [jlo[i], jhi[i]) built on the card by csrc/band_build.cu
// (the reference tool's chained k-mer band). Cells in the band follow the
// recurrence of csrc/sw_pair.cu:
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
// Three routes; the wrapper picks one from (lx, ly) alone
// (ops/sw_cuda.banded_route):
//   packed  ly <= 32,767: two problems per thread, below;
//   word32  min(lx, ly) up to 65,535: one problem per thread, 32-bit
//           scratch word;
//   word64  from 65,536: the same with a 64-bit scratch word (kWide).
// The packed route holds H (at most min(lx, ly)) and a strip's bounds, as
// offsets from its first column, in int16 halves, which ly <= 32,767
// keeps in range whatever the bounds; the scalar routes compare the int32
// bounds themselves.
//
// Strips and zones, on every route. A thread sweeps the haplotype once per
// strip of kStrip = 8 read rows, holding the strip's read bases, per-row H
// (or G = H - 6) and E, and the rows' bounds in registers; the bottom
// row's words of each column go to the next strip through global scratch.
// A strip visits the columns [c0, c1) of its rows' union (strips with no
// in-band row are skipped), in three zones:
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
// (H, F) = (0, NEG), so scratch is never cleared. The row scan starts at
// c0 with H = 0 and E = NEG on its left, exact because that column is left
// of every row's band. Bounds load per strip from a [row][problem] layout,
// so a warp's loads of one row coalesce. Scratch is indexed by the
// column's offset from the strip's first column, [j - c0][thread], not by
// the column itself: the lanes of a warp hold problems whose bands start
// at different columns, and at the same step they then touch neighbouring
// words instead of 32 rows of the buffer. On the scalar routes two buffers
// alternate by strip, since a strip reads its predecessor's words at
// offsets from that strip's first column (the packed route's use of them
// is below). The wrapper bounds the scratch with a budget and launches
// over ranges of reads that fit it. The K4 layout (128 lanes per
// diagonal, the reversed y buffer) hid the TPU's wavefront ramp and is not
// carried over.
//
// Packed route (sw_banded16x2_kernel). Thread k owns problems 2k and
// 2k + 1, low half and high half: a read's ref and alt (per_read == 2: the
// read's bases are shared and its int8 code is formed in the thread that
// holds both scores), or two plain rows (per_read == 1; an odd last row
// pairs with an empty problem). Each cell is sw_pair.cu's packed update
// on G = H - 6 (an xnor and six 16x2 add-maxes, half a three-way max for
// the best; see there). A strip's zones are those of the union of both
// problems' bands: its columns run from the least c0 to the greatest c1
// of the two, and its core is the intersection of both problems' live
// rows' bands, so a SNV's ref and alt bands, on nearly one diagonal, share
// most of their cells, and an indel's alt band, shifted past the variant,
// widens the union. In the entry and exit zones a cell's two halves are
// masked apart: two add-maxes give max(lo - 1 - J, J - hi) in each half
// (J the column's offset from the strip's first, lo and hi its row's
// bounds there), negative in the band; a PRMT spreads each half's sign
// into a mask, and one LOP3 per value sets G and the next row's F to -6
// (H = 0, F = NEG) outside the band; E needs no select (below).
//
// The zones run two columns per step (kCols) from c0, and a warp's active
// lanes run them together (warp reductions of their zones): the entry
// zone as many steps as its widest lane needs, the core only the steps
// inside every lane's core, the exit zone to the end of the widest lane's
// columns. A column moved from a lane's core to a masked zone, or one past
// its c1 (out of every band, clipped at ly), is exact, only slower; in
// exchange a warp's lanes write their scratch words of a step side by
// side. Scratch: one (G, F) pair of packed words per thread and column,
// 8 bytes, in two buffers of ly (rounded up to kCols) columns; a strip
// that starts at or right of the strip above writes into the buffer it
// reads (the usual case, so the scratch that the L2 cache must hold is
// halved), one that starts left of it into the other. A step's scratch
// words load during the step before; the haplotype rows' bytes come from
// a window of two aligned words per row (HapWindow), one 32-bit load per
// row every two steps in place of two byte loads per step.
//
// Measured at the main shape on the H100, builds of this file with one
// choice changed: 8-row strips beat 4 and 16, two columns per step beat
// one and four; the haplotype window beat byte loads and 16-bit loads;
// loading the read's bytes as words and a third window word did not help;
// 4 blocks per SM (128 registers) beat 5 (96, with spills).
// chip_smoke.py --band times the kernel against copies without scratch
// traffic and with one haplotype pair for every thread.
//
// Scalar routes (sw_banded_kernel), one problem per thread in 32-bit
// registers: each 8-row strip sweeps one column per iteration; the bottom
// row's (H, F + 6) goes to scratch as one 32-bit word of two 16-bit halves
// while min(lx, ly) < 65536 (0 <= H, F + 6 <= min(lx, ly)) and past that
// a 64-bit one (kWide).
//
// E needs no select on either route: left of a row's band every H of the
// row is 0, so E stays at NEG (-6) there; right of it E is wrong but feeds
// only the row's cells further right, all out of band.
//
// Bound. Like sw_pair.cu the work is integer instructions, bounded by
// instruction issue (4 warp instructions per SM and clock) and, for the
// packed route, by the DPX pipe, which issues 16x2 add-maxes at about half
// that rate: the in-band cells at the recurrence's own least cost per
// cell (chip_smoke.py's cell probe). The entry and exit zones (a diagonal
// band of width ~41 seen through an 8-row strip has ~7 masked columns on
// each side, more where a pair's bands part) and the out-of-band cells
// inside the strips' rectangles are the overhead; chip_smoke.py reads each
// route's instructions per cell in its core and masked loops from
// cuobjdump -sass, and reports the visited and core cells. Lanes of a warp
// hold problems with different column ranges, so on the scalar routes a
// warp runs as long as its widest lane in each zone, and on the packed
// route the narrower lanes compute masked columns (chip_smoke.py reports
// the idle lane slots).

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
constexpr int kPackedMax = 32767;   // the packed route: ly <= this
constexpr int kWord32Max = 65535;   // word32: min(lx, ly) <= this

enum Route { kPackedRoute = 0, kWord32Route = 1, kWord64Route = 2 };

// True length of a read: its last non-pad byte.
__device__ __forceinline__ int read_length(const uint8_t* __restrict__ row,
                                           int lx) {
  int n = lx;
  while (n > 0 && __ldg(row + n - 1) == 0) --n;
  return n;
}

// ---------------------------------------------------------------- packed

// v in both int16 halves
constexpr uint32_t splat(int v) {
  return (static_cast<uint32_t>(v) & 0xffffu) * 0x00010001u;
}
constexpr uint32_t kP1 = splat(1), kPm1 = splat(-1);
// G = H - 6 of H = 0, and the stored F and E of "no gap": -6 (kNeg)
constexpr uint32_t kPm6 = splat(kGapOpenExtend);

// The packed loop's second constants of q and T6: a DPX instruction takes
// at most one immediate, and a value the compiler cannot see stays in a
// register instead of being rebuilt before every use.
__device__ uint32_t gPackedConsts[2] = {splat(8), kPm6};

// Columns per step of the packed loop: a step's scratch words load during
// the step before.
constexpr int kCols = 2;
// Blocks of kThreads per SM the packed kernel is compiled for: 4 (at most
// 128 registers a thread); 5 (at most 96) spills and measured slower.
constexpr int kPackedBlocks = 4;

// A strip's bounds on the packed route as offsets from its first column
// c0, both halves in one word: row r's lower bound less one and its
// upper bound negated, so that a column at offset J lies in a half's band
// when max(lo - 1 - J, J - hi) < 0 there (each offset within [0, 32,767]
// while ly <= 32,767: no add wraps).
struct StripBands {
  uint32_t lo1[kStrip];
  uint32_t nhi[kStrip];
};

// int16 halves from two ints, each in int16 range
__device__ __forceinline__ uint32_t pack16x2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         (static_cast<uint32_t>(hi) << 16);
}

// 0xffff in each half of v that is negative, else 0
__device__ __forceinline__ uint32_t sign_mask16x2(uint32_t v) {
  uint32_t m;
  asm("prmt.b32 %0, %1, 0, 0xbb99;" : "=r"(m) : "r"(v));
  return m;
}

// A haplotype row's bytes at the sweep's column j, in two aligned words
// of the row: cur from column j - o (o = 0..3), nxt the four after it. A
// step takes the bytes of columns j and j + 1 and, when that empties cur,
// loads the word after nxt, so the row costs one 32-bit load per two
// steps instead of two byte loads per step (byte loads of 32 lanes'
// rows touch 32 lines a warp instruction). A word that starts at or past
// column ly is never loaded (the pad in its place); one that starts
// before it shares an aligned word with a byte of the row, so no load
// leaves the row's pages.
struct HapWindow {
  uint32_t cur, nxt;
  int o;
};

constexpr uint32_t kPadWord = 0x01010101u;
constexpr uint32_t kPadHalves = splat(1) << 3;  // the pad byte in each half

__device__ __forceinline__ uint32_t row_word(const uint8_t* __restrict__ row,
                                             int w, int ly) {
  return w < ly ? __ldg(reinterpret_cast<const uint32_t*>(row + w))
                : kPadWord;
}

// The window of `row` at column j.
__device__ __forceinline__ void window_at(HapWindow& h,
                                          const uint8_t* __restrict__ row,
                                          int j, int ly) {
  h.o = static_cast<int>((reinterpret_cast<uintptr_t>(row) + j) & 3);
  h.cur = row_word(row, j - h.o, ly);
  h.nxt = row_word(row, j - h.o + 4, ly);
}

// Bytes j and j + 1 of the row (in the low 16 bits; past ly, any), then
// the window moved to column j + 2.
__device__ __forceinline__ uint32_t window_take(HapWindow& h,
                                                const uint8_t* __restrict__ row,
                                                int j, int ly) {
  const uint32_t v = __funnelshift_r(h.cur, h.nxt, 8 * h.o);
  h.o += 2;
  if (h.o >= 4) {
    h.o -= 4;
    h.cur = h.nxt;
    h.nxt = row_word(row, j + 6 - h.o, ly);
  }
  return v;
}

// The haplotype words of the step at column j: each half a haplotype byte
// shifted left by 3 (so x ^ y is 0 on a match and at least 8 otherwise),
// the pad byte 1 from column ly on.
__device__ __forceinline__ void step_haps(HapWindow& w0, HapWindow& w1,
                                          const uint8_t* __restrict__ h0,
                                          const uint8_t* __restrict__ h1,
                                          int j, int ly,
                                          uint32_t (&y)[kCols]) {
  static_assert(kCols == 2, "a step takes two bytes of each row");
  const uint32_t t = __byte_perm(window_take(w0, h0, j, ly),
                                 window_take(w1, h1, j, ly), 0x5410);
  y[0] = j < ly ? (t & 0x00ff00ffu) << 3 : kPadHalves;
  y[1] = j + 1 < ly ? (t >> 5) & 0x07f807f8u : kPadHalves;
}

// (G, F) of the previous strip's bottom row at column j: its scratch words
// inside the columns [pv_lo, pv_lo + pv_w) it visited, else H = 0, F = NEG.
__device__ __forceinline__ uint2 above(const uint2* __restrict__ col_in,
                                       int j, int pv_lo, int pv_w,
                                       size_t stride) {
  const unsigned off = static_cast<unsigned>(j - pv_lo);
  return off < static_cast<unsigned>(pv_w) ? col_in[off * stride]
                                           : make_uint2(kPm6, kPm6);
}

// Steps [m, m_end) of one strip, step m the columns c0 + kCols m, ...;
// the strip has n_steps. kMasked: each cell's halves are masked by their
// rows' bands, (G, F) = (-6, -6) outside; else every cell is computed as
// in sw_pair.cu. win0, win1: the haplotype rows' windows at step m's
// column; w_next: the scratch words of step m, loaded by the step before
// (or the strip's setup); the last step loads those of the next zone's
// first step.
template <bool kMasked>
__device__ __forceinline__ void sweep16x2(
    int m, int m_end, int n_steps, const StripBands& band,
    const uint32_t (&xs)[kStrip], uint32_t (&g)[kStrip],
    uint32_t (&e)[kStrip], uint32_t& g_up_prev, uint32_t& best,
    HapWindow& win0, HapWindow& win1, uint2 (&w_next)[kCols],
    const uint8_t* __restrict__ h0, const uint8_t* __restrict__ h1, int ly,
    const uint2* __restrict__ col_in, uint2* __restrict__ col_out,
    size_t stride, int pv_lo, int pv_w, int c0, bool last, uint32_t k8,
    uint32_t km6) {
  for (; m < m_end; ++m) {
    const int j = c0 + kCols * m;
    uint32_t y[kCols];
    step_haps(win0, win1, h0, h1, j, ly, y);
    uint2 w[kCols];
#pragma unroll
    for (int d = 0; d < kCols; ++d) w[d] = w_next[d];
    if (m + 1 < n_steps) {
#pragma unroll
      for (int d = 0; d < kCols; ++d) {
        w_next[d] = above(col_in, j + kCols + d, pv_lo, pv_w, stride);
      }
    }
#pragma unroll
    for (int d = 0; d < kCols; ++d) {
      const int jj = j + d;
      const uint32_t off = (jj - c0) * 0x00010001u;  // J in both halves
      const uint32_t noff = ((c0 - jj) & 0xffff) * 0x00010001u;  // -J
      uint32_t diag = g_up_prev;
      g_up_prev = w[d].x;
      uint32_t f = w[d].y;
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        e[r] = __viaddmax_s16x2(e[r], kPm1, g[r]);
        const uint32_t q = __viaddmax_s16x2(~(xs[r] ^ y[d]), k8, kP1);
        const uint32_t t = __viaddmax_s16x2_relu(diag, q, e[r]);
        const uint32_t t6 = __viaddmax_s16x2(t, km6, kPm6);
        diag = g[r];
        uint32_t gn = __viaddmax_s16x2(f, kPm6, t6);
        f = __viaddmax_s16x2(f, kPm1, t6);
        if (kMasked) {
          // J - hi, then max(lo - 1 - J, J - hi): negative in band
          const uint32_t v = __viaddmax_s16x2(
              band.lo1[r], noff,
              __viaddmax_s16x2(off, band.nhi[r], 0x80008000u));
          const uint32_t m = sign_mask16x2(v);
          gn = (gn & m) | (kPm6 & ~m);
          f = (f & m) | (kPm6 & ~m);
        }
        g[r] = gn;
        if (r & 1) best = __vimax3_s16x2(best, g[r - 1], g[r]);
      }
      if (!last) {
        col_out[(kCols * m + d) * stride] = make_uint2(g[kStrip - 1], f);
      }
    }
  }
}

// Best banded local scores, as G = H - 6 in the low and high half, of two
// problems: reads row0 / row1 (len0 / len1 bases; row1 == row0 when
// `shared`) of a bucket of width lx against haplotype rows h0 / h1 (ly
// bytes). lo0, hi0: the low problem's bounds of row 0, rows bound_stride
// apart, the high problem's at lo0 + 1, hi0 + 1 (has0, has1 false: an
// empty problem, no bounds read). col: this thread's scratch column,
// stride between columns, two buffers of ly rounded up to kCols columns.
// Every thread of the warp calls it: a strip's active lanes step through
// its zones together (warp reductions of their widths), so that at each
// step their scratch words lie side by side, and a lane whose zones are
// narrower computes the columns the warp adds to them masked (the core
// shrinks to the lanes' common part, the exit zone runs past a lane's c1).
__device__ uint32_t sw_banded16x2(const uint8_t* __restrict__ row0, int len0,
                                  const uint8_t* __restrict__ row1, int len1,
                                  bool shared, int lx,
                                  const uint8_t* __restrict__ h0,
                                  const uint8_t* __restrict__ h1, int ly,
                                  const int32_t* __restrict__ lo0,
                                  const int32_t* __restrict__ hi0, bool has0,
                                  bool has1, size_t bound_stride,
                                  uint2* __restrict__ col, size_t stride) {
  const uint32_t k8 = gPackedConsts[0], km6 = gPackedConsts[1];
  const size_t buffer = static_cast<size_t>((ly + kCols - 1) / kCols * kCols)
                        * stride;
  uint32_t best = kPm6;
  int pv_lo = 0, pv_w = 0;  // columns the strip above visited
  int in_buf = 0;           // the buffer that holds its words
  const int n_strips = (lx + kStrip - 1) / kStrip;
  for (int s = 0; s < n_strips; ++s) {
    int lo[2][kStrip], hi[2][kStrip];
    int c0 = ly, c1 = 0, core_lo = 0, core_hi = ly;
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      const int i = s * kStrip + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lo[h][r] = hi[h][r] = 0;
        if (i < lx && (h ? has1 : has0)) {
          lo[h][r] = __ldg(lo0 + i * bound_stride + h);
          hi[h][r] = __ldg(hi0 + i * bound_stride + h);
        }
        if (lo[h][r] < hi[h][r]) {
          c0 = min(c0, lo[h][r]);
          c1 = max(c1, hi[h][r]);
        }
        if (i < (h ? len1 : len0)) {
          core_lo = max(core_lo, lo[h][r]);
          core_hi = min(core_hi, hi[h][r]);
        }
      }
    }
    c0 = max(c0, 0);
    c1 = min(c1, ly);
    const bool run = c0 < c1;
    const unsigned active = __ballot_sync(0xffffffffu, run);
    if (!run) {  // no cell of the strip in either band
      pv_lo = pv_w = 0;
      continue;
    }
    const int a = max(c0, min(core_lo, c1));  // [a, b): the core
    const int b = max(a, min(core_hi, c1));
    // zones in steps of kCols columns from c0, the warp's: entry steps
    // [0, n_entry), core [n_entry, n_core), exit [n_core, n_steps)
    const int n_entry =
        __reduce_max_sync(active, (a - c0 + kCols - 1) / kCols);
    const int n_core =
        max(__reduce_min_sync(active, (b - c0) / kCols), n_entry);
    const int n_steps =
        __reduce_max_sync(active, (c1 - c0 + kCols - 1) / kCols);
    StripBands band;
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      int o[2][2];  // [half]: lo, hi as offsets from c0 within [0, ly]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[h][0] = min(max(lo[h][r] - c0, 0), kPackedMax);
        o[h][1] = max(min(hi[h][r], ly) - c0, 0);
      }
      band.lo1[r] = pack16x2(o[0][0] - 1, o[1][0] - 1);
      band.nhi[r] = pack16x2(-o[0][1], -o[1][1]);
    }
    uint32_t xs[kStrip], g[kStrip], e[kStrip];
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      const int i = s * kStrip + r;
      const uint32_t b0 = i < len0 ? __ldg(row0 + i) : 0u;
      const uint32_t b1 = shared ? b0 : (i < len1 ? __ldg(row1 + i) : 0u);
      xs[r] = (b0 | (b1 << 16)) << 3;
      g[r] = kPm6;  // H left of the strip's first column, minus 6
      e[r] = kPm6;  // E = NEG
    }
    const bool last = s == n_strips - 1;
    // a strip that starts at or right of the strip above writes over the
    // words it reads: step m writes offsets below any it reads later
    const int out_buf = c0 >= pv_lo ? in_buf : in_buf ^ 1;
    const uint2* col_in = col + in_buf * buffer;
    uint2* col_out = col + out_buf * buffer;
    uint32_t g_up_prev =  // G[i0-1][c0-1]
        c0 > 0 ? above(col_in, c0 - 1, pv_lo, pv_w, stride).x : kPm6;
    HapWindow win0, win1;
    window_at(win0, h0, c0, ly);
    window_at(win1, h1, c0, ly);
    uint2 w_next[kCols];
#pragma unroll
    for (int d = 0; d < kCols; ++d) {
      w_next[d] = above(col_in, c0 + d, pv_lo, pv_w, stride);
    }
    sweep16x2<true>(0, n_entry, n_steps, band, xs, g, e, g_up_prev, best,
                    win0, win1, w_next, h0, h1, ly, col_in, col_out, stride,
                    pv_lo, pv_w, c0, last, k8, km6);
    sweep16x2<false>(n_entry, n_core, n_steps, band, xs, g, e, g_up_prev,
                     best, win0, win1, w_next, h0, h1, ly, col_in, col_out,
                     stride, pv_lo, pv_w, c0, last, k8, km6);
    sweep16x2<true>(n_core, n_steps, n_steps, band, xs, g, e, g_up_prev,
                    best, win0, win1, w_next, h0, h1, ly, col_in, col_out,
                    stride, pv_lo, pv_w, c0, last, k8, km6);
    pv_lo = c0;
    pv_w = kCols * n_steps;
    in_buf = out_buf;
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
// problem). Either way its bounds are columns 2k and 2k + 1 of jlo/jhi.
// Outputs as sw_banded_kernel.
template <bool kCodes>
__global__ void __launch_bounds__(kThreads, kPackedBlocks)
sw_banded16x2_kernel(const uint8_t* __restrict__ reads, int n_reads, int lx,
                     const uint8_t* __restrict__ haps, int ly,
                     const int32_t* __restrict__ idx_ref,
                     const int32_t* __restrict__ idx_alt, int per_read,
                     const int32_t* __restrict__ jlo,
                     const int32_t* __restrict__ jhi, size_t bound_stride,
                     int32_t* __restrict__ scores, int score_stride,
                     int8_t* __restrict__ codes, uint2* __restrict__ scratch) {
  const size_t n_prob = per_read * static_cast<size_t>(n_reads);
  const size_t n_pairs = (n_prob + 1) / 2;
  const size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // a thread past the pairs runs as two empty problems: its warp's strips
  // take warp-wide steps
  const bool live = k < n_pairs;
  const bool shared = per_read == 2;
  const int read0 = live ? static_cast<int>(shared ? k : 2 * k) : 0;
  const bool has1 = live && (shared || 2 * k + 1 < n_prob);
  const int read1 = shared || !has1 ? read0 : read0 + 1;
  const uint8_t* row0 = reads + static_cast<size_t>(read0) * lx;
  const uint8_t* row1 = reads + static_cast<size_t>(read1) * lx;
  const int len0 = live ? read_length(row0, lx) : 0;
  const int len1 = shared ? len0 : (has1 ? read_length(row1, lx) : 0);
  const int hidx0 = live ? __ldg(idx_ref + read0) : 0;
  const int hidx1 = !has1 ? hidx0
                          : __ldg((shared ? idx_alt : idx_ref) + read1);
  const uint32_t best = sw_banded16x2(
      row0, len0, row1, len1, shared, lx,
      haps + static_cast<size_t>(hidx0) * ly,
      haps + static_cast<size_t>(hidx1) * ly, ly, jlo + 2 * (live ? k : 0),
      jhi + 2 * (live ? k : 0), live, has1, bound_stride,
      scratch + (live ? k : 0), n_pairs);
  if (!live) return;
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

// Columns [j0, j1) of one strip. kMasked: each cell is tested against its
// row's band and set to (H, F) = (0, NEG) outside it; else every cell is
// computed as in sw_pair.cu.
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
  const int len_x = read_length(row, lx);
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

// per_read == 2: problem p scores read p/2 against idx_ref (p even) or
// idx_alt (p odd); per_read == 1: read p against idx_ref[p]. Its bounds
// are column p of jlo/jhi, rows bound_stride apart.
// kCodes (per_read == 2 only): one int8 call code per read, else int32
// scores [per_read][score_stride] (columns [0, n_reads) written).
template <bool kCodes, bool kWide>
__global__ void __launch_bounds__(kThreads)
sw_banded_kernel(const uint8_t* __restrict__ reads, int n_reads, int lx,
                 const uint8_t* __restrict__ haps, int ly,
                 const int32_t* __restrict__ idx_ref,
                 const int32_t* __restrict__ idx_alt, int per_read,
                 const int32_t* __restrict__ jlo,
                 const int32_t* __restrict__ jhi, size_t bound_stride,
                 int32_t* __restrict__ scores, int score_stride,
                 int8_t* __restrict__ codes,
                 typename Word<kWide>::T* __restrict__ scratch) {
  const size_t n_prob = per_read * static_cast<size_t>(n_reads);
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = p < n_prob;
  const bool pair = per_read == 2;
  const int read = live ? static_cast<int>(pair ? p >> 1 : p) : 0;
  const int which = pair ? static_cast<int>(p & 1) : 0;
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

// ---------------------------------------------------------------- launch

struct Args {
  const uint8_t* reads;
  int n_reads, lx;
  const uint8_t* haps;
  int ly;
  const int32_t* idx_ref;
  const int32_t* idx_alt;
  int per_read;
  const int32_t* jlo;
  const int32_t* jhi;
  size_t bound_stride;
  int32_t* scores;
  int score_stride;
  int8_t* codes;
  void* scratch;
};

unsigned blocks_for(size_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <bool kCodes>
void launch_packed(const Args& a, cudaStream_t stream) {
  const size_t n_prob = a.per_read * static_cast<size_t>(a.n_reads);
  sw_banded16x2_kernel<kCodes>
      <<<blocks_for((n_prob + 1) / 2), kThreads, 0, stream>>>(
          a.reads, a.n_reads, a.lx, a.haps, a.ly, a.idx_ref, a.idx_alt,
          a.per_read, a.jlo, a.jhi, a.bound_stride, a.scores, a.score_stride,
          a.codes, static_cast<uint2*>(a.scratch));
}

template <bool kCodes, bool kWide>
void launch_scalar(const Args& a, cudaStream_t stream) {
  const size_t n_prob = a.per_read * static_cast<size_t>(a.n_reads);
  sw_banded_kernel<kCodes, kWide><<<blocks_for(n_prob), kThreads, 0,
                                    stream>>>(
      a.reads, a.n_reads, a.lx, a.haps, a.ly, a.idx_ref, a.idx_alt,
      a.per_read, a.jlo, a.jhi, a.bound_stride, a.scores, a.score_stride,
      a.codes, static_cast<typename Word<kWide>::T*>(a.scratch));
}

template <bool kCodes>
void launch_route(int route, const Args& a, cudaStream_t stream) {
  if (route == kPackedRoute) {
    launch_packed<kCodes>(a, stream);
  } else if (route == kWord32Route) {
    launch_scalar<kCodes, false>(a, stream);
  } else {
    launch_scalar<kCodes, true>(a, stream);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a per_read other than 1 or 2, codes with
// per_read 1, or a route that cannot hold min(lx, ly). reads: uint8
// [n_reads, lx]; haps: uint8 [*, ly]; idx_ref, idx_alt: int32 [n_reads]
// (idx_alt unread when per_read == 1); jlo, jhi: int32 [lx, bound_stride],
// problem p's bounds in column p (p < per_read n_reads). Exactly one of
// scores (int32 [per_read, score_stride], columns [0, n_reads) written) and
// codes (int8 [n_reads], per_read 2) is non-null. route: 0 packed
// (ly <= 32,767; scratch uint2 [2, ly rounded up to a multiple of
// 2, ceil(n_reads * per_read / 2)]), 1 word32 (<= 65,535; uint32 [2 ly,
// n_reads * per_read]), 2 word64 (any; uint64, the same shape). No scratch
// is needed when lx <= 8 (one strip).
int sw_banded_launch(const void* reads, int n_reads, int lx, const void* haps,
                     int ly, const void* idx_ref, const void* idx_alt,
                     int per_read, const void* jlo, const void* jhi,
                     long long bound_stride, void* scores, int score_stride,
                     void* codes, void* scratch, int route, void* stream) {
  const int width = min(lx, ly);
  if ((per_read != 1 && per_read != 2) || (codes && per_read != 2) ||
      (route == kPackedRoute && ly > kPackedMax) ||
      (route == kWord32Route && width > kWord32Max) || route < kPackedRoute ||
      route > kWord64Route) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (per_read * static_cast<size_t>(n_reads) == 0) return 0;
  const Args a{static_cast<const uint8_t*>(reads), n_reads, lx,
               static_cast<const uint8_t*>(haps), ly,
               static_cast<const int32_t*>(idx_ref),
               static_cast<const int32_t*>(idx_alt), per_read,
               static_cast<const int32_t*>(jlo),
               static_cast<const int32_t*>(jhi),
               static_cast<size_t>(bound_stride),
               static_cast<int32_t*>(scores), score_stride,
               static_cast<int8_t*>(codes), scratch};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (codes) {
    launch_route<true>(route, a, st);
  } else {
    launch_route<false>(route, a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sw_banded_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
