// Exact affine-gap local Smith-Waterman scores of (read, haplotype)
// problems, one problem per thread, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of the default full-SW path, which all
// compute this one function (vartrix_tpu/ops/sw_pallas_v2.py):
//   K1 _sw_kernel_v4  one (read, hap) pair per lane (plain (x, y) batches);
//   K2 _sw_kernel_v5  one read against ref ++ alt chained along y;
//   K3 _sw_kernel_v6  two reads per lane against r1ref ++ r1alt ++ r2ref ++
//                     r2alt (the production kernel).
// The chaining and the 128-lane layout only recover wavefront ramp waste on
// the TPU. Here each thread owns one (read, haplotype) problem, so no ramp
// exists and every problem stops at its own true lengths. The device glue
// of the jitted entries is fused into the load and store stages: the 2-bit
// read unpack (_unpack2), the gather of haplotype rows by index, and the
// reduction of each read's (ref, alt) scores to one int8 call code.
//
// Recurrence (Gotoh, same as ops/sw_torch.py and the reference's NumPy
// oracle): MATCH +1, MISMATCH -5, a gap of length L costs -5 - L.
//   E[i][j] = max(H[i][j-1] - 6, E[i][j-1] - 1)      gap along the haplotype
//   F[i][j] = max(H[i-1][j] - 6, F[i-1][j] - 1)      gap along the read
//   H[i][j] = max(H[i-1][j-1] + s(x[i], y[j]), E, F, 0)
// Bases compare as raw bytes. Reads pad with byte 0 and haplotypes with
// byte 1; pad never equals a base, so pad cells only lower a path's score
// and each problem stops at its last non-pad read row and haplotype column.
//
// Layout. A thread sweeps the haplotype columns once per strip of S = 16
// read rows. The strip's read bases and its per-row H and E live in
// registers; F chains down the strip's column. Between strips the bottom
// row's (H, F) of every column goes through a global scratch buffer laid
// out [column][problem], so neighbouring threads touch neighbouring words.
// Once computed, 0 <= H <= min(len_x, len_y) < 65536 and -6 <= F <= that
// bound - 6 (F is an H above minus 6, or an F above minus 1), so H and F + 6
// both fit 16 unsigned bits and the pair packs into one 32-bit word (H low
// half, F + 6 high half). The wrapper refuses min(lx, ly) >= 65536.
//
// Bound. The work is integer instructions. Integer adds and moves can run
// on the FMA pipe as well as on the 64-lane INT32 pipe, so the int32 rate
// that bounds it on this card is instruction issue: each SM issues at most 4
// warp instructions (128 thread instructions) per clock. The compiled
// hot loop (nvcc 12.9, sm_90a; chip_smoke.py reads it from cuobjdump -sass
// on every run) issues 158 instructions per column of a 16-row strip, 9.875
// per cell: per cell a compare and two adds for diag + s (match +1 or
// mismatch -5), an add and a DPX add-max (VIADDMNMX) each for E and F, one
// DPX three-way max with zero (VIMNMX3.RELU) for H and half a three-way max
// for the running best (8.5), and per column the haplotype byte load, the
// scratch load and store, packing and loop control (22). At 132 SMs x 128
// x 1.98 GHz = 33.45 T instructions/s that is ~0.3 ns per 1000 cells. The
// scratch traffic is 8 bytes per column per strip, 0.5 byte per cell, well
// under the memory bound. The design keeps the cell loop to those
// instructions: no shuffles, no shared memory, DPX for the fused add-max
// and three-way max steps, one scratch word per column, and per-problem
// early stops so padded columns and strips of the bucket are not computed.

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

// 'A', 'C', 'G', 'T' for 2-bit codes 0..3 (gio_gather_padded_packed2)
constexpr uint32_t kAcgt = 'A' | ('C' << 8) | ('G' << 16) | ('T' << 24);

template <bool kPacked2>
__device__ __forceinline__ int read_base(const uint8_t* __restrict__ row,
                                         int i, int len) {
  if (i >= len) return 0;
  if (kPacked2) {
    const int code = (__ldg(row + (i >> 2)) >> ((i & 3) * 2)) & 3;
    return (kAcgt >> (code * 8)) & 0xff;
  }
  return __ldg(row + i);
}

// Best local score of one read (row, len_x bases) against one haplotype
// (hrow, len_y bases). col: this problem's scratch column, stride between
// haplotype positions.
template <bool kPacked2>
__device__ int sw_problem(const uint8_t* __restrict__ row, int len_x,
                          const uint8_t* __restrict__ hrow, int len_y,
                          uint32_t* __restrict__ col, size_t stride) {
  int best = 0;
  const int n_strips = (len_x + kStrip - 1) / kStrip;
  for (int s = 0; s < n_strips; ++s) {
    int xs[kStrip], hl[kStrip], e[kStrip];
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      xs[r] = read_base<kPacked2>(row, s * kStrip + r, len_x);
      hl[r] = 0;     // H[i][-1]
      e[r] = kNeg;   // E[i][-1]
    }
    const bool first = s == 0;
    const bool last = s == n_strips - 1;
    int h_up_prev = 0;  // H[i0-1][j-1]
    for (int j = 0; j < len_y; ++j) {
      const int yj = __ldg(hrow + j);
      int h = 0, f = kNeg;  // H[i0-1][j], F[i0-1][j]
      if (!first) {
        const uint32_t w = col[j * stride];
        h = static_cast<int>(w & 0xffffu);
        f = static_cast<int>(w >> 16) + kGapOpenExtend;
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
        col[j * stride] = (static_cast<uint32_t>(f - kGapOpenExtend) << 16) |
                          static_cast<uint32_t>(h);
      }
    }
  }
  return best;
}

// per_read == 2: problem p scores read p/2 against idx_ref (p even) or
// idx_alt (p odd); per_read == 1: read p against idx_ref[p].
// kCodes (per_read == 2 only): one int8 call code per read, else int32
// scores [per_read][n_reads].
template <bool kPacked2, bool kCodes>
__global__ void __launch_bounds__(kThreads)
sw_pair_kernel(const uint8_t* __restrict__ reads,
               const int32_t* __restrict__ read_lens, int n_reads, int lx,
               int row_bytes, const uint8_t* __restrict__ haps, int ly,
               const int32_t* __restrict__ idx_ref,
               const int32_t* __restrict__ idx_alt, int per_read,
               int32_t* __restrict__ scores, int8_t* __restrict__ codes,
               uint32_t* __restrict__ scratch) {
  const size_t n_prob = static_cast<size_t>(n_reads) * per_read;
  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = p < n_prob;
  const int read = live ? static_cast<int>(per_read == 2 ? p >> 1 : p) : 0;
  const int which = per_read == 2 ? static_cast<int>(p & 1) : 0;
  int best = 0;
  if (live) {
    const uint8_t* row = reads + static_cast<size_t>(read) * row_bytes;
    int len_x;
    if (kPacked2) {
      len_x = min(max(__ldg(read_lens + read), 0), lx);
    } else {
      len_x = lx;
      while (len_x > 0 && __ldg(row + len_x - 1) == 0) --len_x;
    }
    const int hidx = __ldg((which ? idx_alt : idx_ref) + read);
    const uint8_t* hrow = haps + static_cast<size_t>(hidx) * ly;
    int len_y = ly;
    while (len_y > 0 && __ldg(hrow + len_y - 1) == 1) --len_y;
    if (len_x > 0 && len_y > 0) {
      best = sw_problem<kPacked2>(row, len_x, hrow, len_y, scratch + p,
                                  n_prob);
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
    scores[static_cast<size_t>(which) * n_reads + read] = best;
  }
}

template <bool kPacked2, bool kCodes>
void launch(unsigned blocks, cudaStream_t stream, const uint8_t* reads,
            const int32_t* read_lens, int n_reads, int lx, int row_bytes,
            const uint8_t* haps, int ly, const int32_t* idx_ref,
            const int32_t* idx_alt, int per_read, int32_t* scores,
            int8_t* codes, uint32_t* scratch) {
  sw_pair_kernel<kPacked2, kCodes><<<blocks, kThreads, 0, stream>>>(
      reads, read_lens, n_reads, lx, row_bytes, haps, ly, idx_ref, idx_alt,
      per_read, scores, codes, scratch);
}

}  // namespace

extern "C" {

// Rows of the scratch buffer a launch needs per problem (0: none).
int sw_pair_scratch_rows(int lx, int ly) { return lx > kStrip ? ly : 0; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// reads: uint8 [n_reads, lx] (packed2 = 0) or [n_reads, lx / 4] 2-bit codes
// with int32 read_lens [n_reads] (packed2 = 1). haps: uint8 [*, ly].
// Exactly one of scores (int32 [per_read, n_reads]) and codes (int8
// [n_reads], per_read = 2) is non-null. scratch: uint32
// [sw_pair_scratch_rows(lx, ly), n_reads * per_read].
int sw_pair_launch(const void* reads, const void* read_lens, int n_reads,
                   int lx, int packed2, const void* haps, int ly,
                   const void* idx_ref, const void* idx_alt, int per_read,
                   void* scores, void* codes, void* scratch, void* stream) {
  const size_t n_prob = static_cast<size_t>(n_reads) * per_read;
  if (n_prob == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_prob + kThreads - 1) / kThreads);
  const int row_bytes = packed2 ? lx / 4 : lx;
  auto* r = static_cast<const uint8_t*>(reads);
  auto* rl = static_cast<const int32_t*>(read_lens);
  auto* h = static_cast<const uint8_t*>(haps);
  auto* ir = static_cast<const int32_t*>(idx_ref);
  auto* ia = static_cast<const int32_t*>(idx_alt);
  auto* sc = static_cast<int32_t*>(scores);
  auto* cd = static_cast<int8_t*>(codes);
  auto* scr = static_cast<uint32_t*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (packed2 && codes) {
    launch<true, true>(blocks, st, r, rl, n_reads, lx, row_bytes, h, ly, ir,
                       ia, per_read, sc, cd, scr);
  } else if (packed2) {
    launch<true, false>(blocks, st, r, rl, n_reads, lx, row_bytes, h, ly, ir,
                        ia, per_read, sc, cd, scr);
  } else if (codes) {
    launch<false, true>(blocks, st, r, rl, n_reads, lx, row_bytes, h, ly, ir,
                        ia, per_read, sc, cd, scr);
  } else {
    launch<false, false>(blocks, st, r, rl, n_reads, lx, row_bytes, h, ly, ir,
                         ia, per_read, sc, cd, scr);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sw_pair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
