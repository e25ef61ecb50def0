#!/usr/bin/env python3
"""GPU smoke check of vartrix_tpu_torch, the PyTorch/CUDA package.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. card and toolchain: name and power limit (nvidia-smi), torch, CUDA;
  2. build: the CUDA kernels sw_pair.cu, sw_banded.cu and band_build.cu
     (nvcc), libgenomio, libcramio (its link line printed) and the host
     band reference band_bounds.cpp (g++) from the checkout's sources,
     three probes (nvcc, SASS only: the least DP cell update, band_build's
     candidate scoring in two forms, and a 4-bit read base's unpack in
     two forms), a DPX rate probe and three probes
     of band_build's split (nvcc: copies of band_build.cu that return
     where its chain DP ends, the lookups probe also before each chunk's
     DP steps; and the chain DP under other problem-to-lane mappings),
     all in parallel, with the compiler's register report;
  3. each kernel against its plain PyTorch version on the card, exact
     equality. sw_pair (int32 scores and int8 codes) on each of its three
     routes: dense, 2-bit and 4-bit reads (each format the family's bytes
     allow, each packed one also against the dense entry) over the shape
     families of the full path, the interleaved-index and plain-row
     entries (the TPU kernels K5 and K6); 4-bit reads with N, '=' and
     IUPAC bytes, odd lengths and an empty read at the main shape, and at
     the packed and word32 routes' limit widths (lx = ly = 32,766 and
     65,534, few cells, on every route that holds them); reads at
     min(lx, ly) = 32,767 that score 32,767, the packed
     route's edge; one read long enough to take the 32-bit scratch word
     near its 16-bit halves' limit; and reads of 65,602 bases against a
     70,000-base haplotype, scored above that limit by the 64-bit word
     (two launches of one warp each, a minute or more, on streams of their
     own beside the rest of this phase; every other check waits on the
     default stream only). band_index: the k-mer
     index of every banded family's haplotypes against its plain version
     on both its routes where they hold the width (shared, on chip, up to
     ly = 8,197; global, merge passes in device memory, any width), and on
     families of its own: rows at the shared route's limit and one byte
     past it (the shared route refused there), rows of one repeated base.
     band_build: its int32
     bounds against the plain version and the host reference on the
     families of the banded path (main, bending bands, full bands, empty
     bands, empty haplotypes, raw bytes, ly=4032, a haplotype wider than
     32,767 bases, low-complexity pairs with thousands of matches), with
     32- and 64-bit chain keys and on both width routes of its chain pass
     (band rows in shared memory, the main width's route, or in a work
     buffer, forced by its width threshold; the 65,602-base reads take the
     work buffer by width), and against the host reference on one
     homopolymer locus at ly=4032 whose matches need several chain-pass
     ranges and on the 65,602-base reads. After each kernel call the
     default stream is synchronised, so that a fault names that kernel,
     family and route. sw_banded: scores and codes on
     those bounds against its plain version, on each of its routes that
     holds the family's width (packed, word32, word64). On every family of
     the banded path, both banded kernels' plain-row mode (read p against
     haplotype row p, the Python host path's): the bounds against the plain
     version and the host reference, the scores on every route against the
     plain version. Two banded families of their own: indel haplotype
     pairs whose ref and alt bands part by more than a band's width, and
     reads at sw_banded's packed limit, ly = 32,767, scoring 32,767, in
     both per_read modes (the bounds against the host reference).
     A 100,000-base haplotype pair (a deletion alt) against 512 reads
     (cut for time), under 16 MiB scratch budgets, small enough that
     band_build, sw_banded and sw_pair each run several ranges, against
     the plain versions and the host reference;
  4. timing at the main bucket shape (lx=160, ly=224, 131,072 pairs) with
     CUDA events: each kernel, its plain version, and its bound at the
     card's instruction issue rate against its bytes; sw_pair's packed
     route also in its three read formats in turns (2-bit, 4-bit, dense)
     with the 4-bit entry's bound, and the haplotypes' 4-bit unpack (once
     per bucket). The DP kernels'
     bound charges each needed cell the least cell update, read from the
     SASS of a probe that includes neither kernel (cuobjdump); beside it
     the SASS of each hot loop and the DPX add-max rate of the card. For
     sw_pair both its packed and its 32-bit scalar route, in turns; for
     sw_banded the same two routes in turns in both per_read modes (and
     plain rows in an order that pairs unrelated problems), and per route
     the instructions per problem cell of its core and of its masked
     zones, the cells it visits, the lane slots its divergence leaves
     idle, its registers, blocks per SM and waves; for band_build (given
     its index) the host
     reference's time per pair (the route it replaced) and its time split
     (CUDA events between the count pass, the device sum, the host read of
     the total and the chain pass; the chain DP and lookups probes' chain
     passes, timed in turns with it, cut the chain pass into its lookups,
     its DP steps (beside their time at full issue) and the traceback with
     the band fill) and its chain DP at 32, 16 and 8 lanes per problem
     (the mapping probe, held to the kernel's own DP); band_index on the
     bucket's haplotype matrix: the kernel alone (100 back-to-back calls
     on buffers allocated once, and replayed from a CUDA graph), the
     wrapper, an empty kernel's launch (the floor no single launch
     beats), torch.sort of the same keys, and both routes by width; both
     banded kernels' plain-row mode on the same 131,072 problems as plain
     rows, in turns with their pair mode, with its bound;
  5. end to end: a seeded 500,000-read dataset (generated in a worker
     process while phase 3 runs) through the driver in
     --sw-mode full and banded, each with --backend cuda in the three
     scoring modes, each repeated with --backend torch (banded: consensus
     only, for time); matrices must agree,
     each mode's kernels must have launched on its cuda runs and never on
     the torch runs, the other mode's never, the index once per shape
     bucket, and the host band reference never; band_index timed on each
     bucket's haplotype matrix of the banded cuda runs. The full
     consensus cuda run writes a --profile-dir trace, read for the card's
     idle share in
     `score` (vartrix_tpu_torch.utils.trace); it must hold every sw_pair
     launch. Then the N dataset: phase 5's BAM with one base set to N in a
     seeded 1 % of the reads (a fourth worker process), full consensus
     with --backend torch and with --backend cuda at prefetch depths 2, 0,
     2, 0, unprofiled and then under --profile-dir (score's idle share and
     the trace's H2D bytes at each depth); every cuda run must ship 4-bit
     read chunks and equal the torch run's matrix. The CLI entry (python
     -m vartrix_tpu_torch) runs on a small dataset in both modes;
  6. input and run control: a sparse whole-genome-like dataset (16 x 4 Mb,
     400 variants, ~1.4 M reads, a BAM over --fetch auto's 64 MiB
     threshold; generated in a second worker process from phase 3), each
     run `python -m vartrix_tpu_torch` in a process of its own that
     reports its peak RSS: --fetch whole (cuda, and torch: the plain
     version), auto (must take regions), regions (full and banded),
     --stream 50 (full with a trace of the `stream` phase, banded, and
     coverage + umi), the VCF as BCF, --num-shards 4 merged by python -m
     vartrix_tpu_torch.parallel.multihost, a .bai rebuilt by python -m
     vartrix_tpu_torch.io.bai, --checkpoint-dir twice (the rerun launches
     sw_pair 0 times); every matrix CSR-equal to its mode's --fetch whole
     run; and in-process the bounded-memory loader forced on against the
     monolithic load, column by column;
  7. CRAM and the Python host: phase 5's dataset written as a CRAM with
     its .crai (by a worker process beside phases 4-6), and a 50,000-read
     cut of it (100 variants, the widths unchanged: the Python record path
     decodes and joins each record in Python, so 500,000 would not fit the
     time limit) as a BAM and a CRAM (a third worker process from phase
     3). In-process, --backend cuda: the CRAM in
     full consensus with --fetch whole and auto and in banded consensus,
     each CSR-equal to phase 5's BAM matrix of its mode with the same
     launches, libcramio's decode taken; --host python on the 50,000-read
     BAM and CRAM in full consensus and on the BAM in banded consensus,
     and on the BAM's N copy (one N in a seeded 1 % of its reads, as
     phase 5's N dataset) in full consensus, where the native host ships
     4-bit reads and haplotypes and the Python host dense plain rows,
     each CSR-equal to the native host's run on the same file, sw_pair
     launched on the full runs and both banded kernels in their plain-row
     mode on the banded one, the host band reference never; then python -m
     vartrix_tpu_torch.io.bai on the 50,000-read CRAM (the writer's
     multi-reference slices are indexed by decoding their records in
     Python), whose .crai must equal the one written with it;
  8. devices and processes, on phase 5's dataset: in-process, --backend
     cuda, --device-agg in full consensus (twice), coverage + umi and
     alt_frac and in banded consensus, and --mesh-devices -1 (a mesh of this one card)
     in full consensus, each CSR-equal to phase 5's run of its mode
     without the option, with its path's kernels launched (`aggregate`
     printed beside phase 5's); MeshSwBackend and build_sharded_step over
     two parts on this card, exactly against one SwBackend (int32 scores
     and int8 codes, dense, 2-bit and 4-bit reads) and one count_block of the
     whole batch, on 65,536 reads of phase 3's main family shape; then two
     `python -m vartrix_tpu_torch --distributed 127.0.0.1:PORT,2,RANK`
     processes on this card in coverage + umi, whose rank 0 writes
     matrices CSR-equal to phase 5's and the same metrics counters, and
     whose rank 1 writes nothing (each process's wall printed).

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.

`python3 chip_smoke.py --band [--baseline DIR]` runs the banded kernels
alone: phases 1 and 2, the SASS counts, phase 3's banded families and
phase 4's banded timing, with sw_banded's split (banded_split: its
packed route against copies without scratch traffic and with one
haplotype pair for all threads, and with other strip heights and blocks
per SM) and band_index's (index_split: the kernel against copies without
its sort and with other thread and row mappings, and the wrapper's host
steps); with --baseline, the band_build.cu and
sw_banded.cu of the checkout at DIR (e.g. the parent commit's, unpacked
by `git archive` under build/) built beside this one and timed against
them in turns at the main shape in both per_read modes, bounds and
scores held equal; band_index too, the kernel alone and the wrapper, on
the main family's haplotypes and on phase 5's bucket (its dataset
generated in a worker, one banded run), the indexes held equal.

`python3 chip_smoke.py --sanitize` runs phase 3's exactness checks
(phase_equality, phase_banded_equality with band_index's families,
check_long_hap, check_banded_limit, check_wide_banded) under
compute-sanitizer's memcheck, racecheck, initcheck and synccheck, a
child process each, at cut sizes (the main family 4,096 reads, the
100 kb locus 64, the homopolymer locus 16; sw_pair's 1 G-cell families
and wide launches left out: sw_pair and sw_banded run every route on
the other families); only this repository's kernels instrumented. It
fails where a tool reports an error (named by kernel, family and route),
or is missing or refuses the device.
"""

import collections
import ctypes
import json
import math
import multiprocessing
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12
# instruction issue per SM and clock on Hopper: 4 schedulers, each one warp
# instruction (32 threads) per clock, whatever pipe the instruction uses
ISSUE_PER_SM_CLK = 4 * 32
# the instantiations the paths launch: full, 2-bit reads and int8 call
# codes on the packed route (and, timed beside it, on the 32-bit scalar
# route); banded, int8 call codes on the packed route (and beside it on
# the 32-bit scalar route); the chain pass with 32-bit chain keys, band
# rows in shared memory
MAIN_KERNEL_SYMBOL = "sw_pair16x2_kernelILi1ELb1E"
SCALAR_KERNEL_SYMBOL = "sw_pair_kernelILi1ELb1ELb0E"
# sw_pair's other read formats on the packed route, int8 codes: dense bytes
# and 4-bit codes (the instantiation reads that carry N take)
PAIR_FORMAT_SYMBOLS = {"dense": "sw_pair16x2_kernelILi0ELb1E",
                       "p2": MAIN_KERNEL_SYMBOL,
                       "p4": "sw_pair16x2_kernelILi2ELb1E"}
BANDED_KERNEL_SYMBOL = "sw_banded16x2_kernelILb1EE"
BANDED_SCALAR_SYMBOL = "sw_banded_kernelILb1ELb0EE"
CHAIN_KERNEL_SYMBOL = "chain_kernelIiLb1EE"
# the SASS instruction that marks one DP cell in each kernel's hot loop:
# on the packed routes one per two problems' cell, the add-max with zero
# (T); on the scalar routes the three-way H maximum with zero; and one
# chain DP step (64 candidate predecessors) in band_build's: the
# warp-wide maximum
PACKED_CELL_OPCODE = "VIADDMNMX.S16x2.RELU"
CELL_OPCODE = "VIMNMX3.RELU"
CHAIN_OPCODE = "REDUX"
# the DPX opcodes (add-max and three-way max) among a loop's instructions
DPX_OPCODES = ("VIADDMNMX", "VIMNMX3")
STRIP = 8  # read rows per strip of sw_banded.cu (kStrip, every route)
# the per-SM limits that, with a kernel's registers, set its blocks per SM
SM_REGISTERS, SM_THREADS, REGISTER_UNIT = 65536, 2048, 8
# band_build's bound charges each chain candidate the instructions of its
# scoring alone and one max, in the least of two forms: band_build.cu's
# `candidate` (included), and the three-way-minimum form written out here,
# with no source of the kernel (min3_probe: the overlap's step as
# min(di, dj, k), the gap penalty as g + 5 min(g, 1), one compare against
# the start score, score x 64 + nearness). Each is the SASS of a loop that
# scores one candidate per iteration less that of the same loop without
# it (its LOP3s, which only consume the loads, not counted), all loading
# the candidate's slot. A key lookup is charged a source count: the key's
# rolling update (shift, or, mask) and one probe of a hashed index of the
# haplotype's keys (hash, load, compare, branch).
PROBE_SRC = r'''
#include "band_build.cu"

// slots: int32 [n, 4], one (i, j, sc, b) per candidate
__global__ void candidate_probe(const int* __restrict__ slots, int n, int a,
                                int i, int j, int* __restrict__ out) {
  int best = 0;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const int* q = slots + 4 * k;
    const Slot v{q[0], q[1], q[2], q[3]};
    best = max(best, candidate(v, a, i, j));
  }
  out[threadIdx.x] = best;
}

// slots: int32 [n, 4], one (i, j, sc, nearness) per candidate; the
// scoring written out: k = 6, a gap of g costs g + 5 (none at g = 0),
// keys below the start score of k are 0
__global__ void min3_probe(const int* __restrict__ slots, int n, int a,
                           int i, int j, int* __restrict__ out) {
  int best = a;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const int* q = slots + 4 * k;
    const int di = i - q[0], dj = j - q[1];
    const int step = __vimin3_s32(di, dj, 6);
    const int g = abs(di - dj);
    const int sc = q[2] + step - (g + 5 * min(g, 1));
    best = max(best, step > 0 && sc > 6 ? sc * 64 + q[3] : 0);
  }
  out[threadIdx.x] = best;
}

// the same loop and loads, consumed by XORs (LOP3) only
__global__ void load_probe(const int* __restrict__ slots, int n, int a,
                           int i, int j, int* __restrict__ out) {
  int acc = a + i + j;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const int* q = slots + 4 * k;
    acc ^= q[0] ^ q[1] ^ q[2] ^ q[3];
  }
  out[threadIdx.x] = acc;
}
'''
KEY_LOOKUP_INSTR = 7
# An empty kernel, launched n times from one C call: one launch of it on a
# stream, timed as a wrapper is, is the least time a single launch takes
# there (band_index's launch floor).
EMPTY_SRC = r'''
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int empty_launch(int n, void* stream) {
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
'''
# The DP kernels' bound charges each needed cell the least update of the
# recurrence on this card: two problems per 32-bit word in 16x2 DPX, as
# one loop step updates two packed cells from loaded inputs (read and
# haplotype words, G = H - 6 of the diagonal and of the left cell) with E
# and F carried: E, the substitution score (xnor, then add-max to 7 or 1),
# H with zero (T), T - 6, G, the next F, and half a three-way max for the
# running best. Its SASS per step, less that of the same loop with only
# its loads (their LOP3s and register moves, which only consume the loads,
# not counted), over four problem cells. It includes neither kernel's
# source.
CELL_PROBE_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>

// ~(a ^ b) in one instruction
__device__ __forceinline__ uint32_t xnor(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, 0, 0xc3;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the second constants of the two add-maxes that take two, in registers
__device__ uint32_t consts[2] = {0x00080008u, 0xfffafffau};

// v: (read word, haplotype word, G diagonal, G left)
__device__ __forceinline__ uint32_t cell(uint4 v, uint32_t& e, uint32_t& f,
                                         uint32_t k8, uint32_t km6) {
  e = __viaddmax_s16x2(e, 0xffffffffu, v.w);
  const uint32_t q = __viaddmax_s16x2(xnor(v.x, v.y), k8, 0x00010001u);
  const uint32_t t = __viaddmax_s16x2_relu(v.z, q, e);
  const uint32_t t6 = __viaddmax_s16x2(t, km6, 0xfffafffau);
  const uint32_t g = __viaddmax_s16x2(f, 0xfffafffau, t6);
  f = __viaddmax_s16x2(f, 0xffffffffu, t6);
  return g;
}

__global__ void cell_probe(const uint4* __restrict__ cells, int n,
                           uint32_t* __restrict__ out) {
  const uint32_t k8 = consts[0], km6 = consts[1];
  uint32_t e = 0x8ad08ad0u, f = 0x8ad08ad0u, best = 0xfffafffau;
#pragma unroll 1
  for (int k = 0; k + 1 < n; k += 2) {
    const uint32_t a = cell(cells[k], e, f, k8, km6);
    const uint32_t b = cell(cells[k + 1], e, f, k8, km6);
    best = __vimax3_s16x2(best, a, b);
  }
  out[threadIdx.x] = best ^ e ^ f;
}

// the same loop and loads, consumed by XORs (LOP3) only
__global__ void cell_load_probe(const uint4* __restrict__ cells, int n,
                                uint32_t* __restrict__ out) {
  uint32_t acc = 0;
#pragma unroll 1
  for (int k = 0; k + 1 < n; k += 2) {
    const uint4 a = cells[k], b = cells[k + 1];
    acc ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
  }
  out[threadIdx.x] = acc;
}
'''
# The 4-bit read entry's bound charges each read base the least unpack of
# its nibble on this card: a loop that loads one byte of two 4-bit codes
# and unpacks both to their symbol bytes of `=ACMGRSVTWYHKDBN`, in two
# forms (sw_pair.cu's read_base<kBits4>: a 64-bit table word chosen by the
# code's high bit, shifted by its low three; and byte permutes of the
# table in four words), less the same loop that loads the byte and
# consumes it alone, over two bases. It includes no kernel's source.
NIBBLE_PROBE_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>

constexpr unsigned long long kLo = 0x565352474d43413dULL;  // "=ACMGRSV"
constexpr unsigned long long kHi = 0x4e42444b48595754ULL;  // "TWYHKDBN"

__device__ __forceinline__ uint32_t by_word(uint32_t code) {
  const unsigned long long w = code & 8 ? kHi : kLo;
  return static_cast<uint32_t>((w >> ((code & 7) * 8)) & 0xff);
}

// the table in registers, four bytes a word
__device__ uint32_t table[4] = {0x4d43413du, 0x56535247u, 0x48595754u,
                                0x4e42444bu};

__device__ __forceinline__ uint32_t by_permute(uint32_t code, uint32_t t0,
                                               uint32_t t1, uint32_t t2,
                                               uint32_t t3) {
  const uint32_t k = code & 7;
  return __byte_perm(code & 8 ? t2 : t0, code & 8 ? t3 : t1, k) & 0xff;
}

__global__ void nibble_word_probe(const uint8_t* __restrict__ row, int n,
                                  uint32_t* __restrict__ out) {
  uint32_t acc = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const uint32_t b = __ldg(row + i);
    acc ^= by_word(b >> 4) ^ (by_word(b & 15) << 8);
  }
  out[threadIdx.x] = acc;
}

__global__ void nibble_permute_probe(const uint8_t* __restrict__ row, int n,
                                     uint32_t* __restrict__ out) {
  const uint32_t t0 = table[0], t1 = table[1], t2 = table[2], t3 = table[3];
  uint32_t acc = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const uint32_t b = __ldg(row + i);
    acc ^= by_permute(b >> 4, t0, t1, t2, t3)
           ^ (by_permute(b & 15, t0, t1, t2, t3) << 8);
  }
  out[threadIdx.x] = acc;
}

// the same loop and load, the byte consumed alone
__global__ void nibble_load_probe(const uint8_t* __restrict__ row, int n,
                                  uint32_t* __restrict__ out) {
  uint32_t acc = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const uint32_t b = __ldg(row + i);
    acc ^= b ^ (b << 8);
  }
  out[threadIdx.x] = acc;
}
'''
# The card's rate of the 16x2 DPX add-max: eight independent chains per
# thread, a full card of warps, timed with CUDA events (a plain C launch,
# bound through ctypes).
DPX_RATE_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void dpx_rate(const uint32_t* __restrict__ in, int iters,
                         uint32_t* __restrict__ out) {
  uint32_t a[8];
  const uint32_t b = in[0];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = in[1 + k] + threadIdx.x;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t n[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        n[k] = __viaddmax_s16x2(a[k], b, a[(k + 1) % 8]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = n[k];
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// blocks x 256 threads, each 32 add-maxes per iteration; 0 = ok
extern "C" int dpx_rate_launch(const void* in, int iters, int blocks,
                               void* out, void* stream) {
  dpx_rate<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), iters, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''
# The chain DP of band_build.cu under other problem-to-lane mappings, for
# the split of phase 4 (a probe: the product kernel keeps a warp per
# problem). group_dp_probe<G>: G lanes per problem, 32 / G problems per
# warp, matches in chunks of G, 64 / G links per lane (this chunk's or the
# one 64 / G back, then 1, 2, ... chunks back), one full-warp reduction per
# problem and match step; the lookups, the gathering of matches into a
# chunk and the scoring (link_key) are band_build.cu's. It stores every
# match and its predecessor distance and writes each problem's best match
# and a checksum of the distances. warp_dp_check writes the same two from
# the kernel's own chain_dp (a warp per problem), the reference each
# mapping is held to.
MAPPING_PROBE_SRC = r'''
#include "band_build.cu"

constexpr int kProbeThreads = 256;
constexpr int kProbeWarps = kProbeThreads / 32;

template <int G>
__global__ void __launch_bounds__(kProbeThreads)
group_dp_probe(const uint8_t* __restrict__ reads, size_t n_prob, int lx,
               int ly, const int32_t* __restrict__ idx_ref,
               const int32_t* __restrict__ idx_alt, int per_read,
               const unsigned long long* __restrict__ keys,
               const int32_t* __restrict__ pos,
               const int32_t* __restrict__ hap_len,
               const long long* __restrict__ ends, int32_t* match_i,
               int32_t* match_j, int32_t* match_prev,
               long long* __restrict__ best_out,
               unsigned* __restrict__ sum_out) {
  constexpr int kGroups = 32 / G, kLinks = kMaxPred / G;
  __shared__ int2 chunk[kProbeWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / G, gl = lane % G, gbase = g * G;
  const size_t p0 = (static_cast<size_t>(blockIdx.x) * kProbeWarps + warp) *
                    kGroups;
  const size_t p = p0 + g;
  Problem q{};
  for (int k = 0; k < kGroups; ++k) {  // each group's problem, by the warp
    if (p0 + k < n_prob) {
      const Problem t = load_problem(reads, lx, ly, idx_ref, idx_alt,
                                     per_read, keys, pos, hap_len, p0 + k);
      if (k == g) q = t;
    }
  }
  const long long start = p < n_prob && p ? ends[p - 1] : 0;
  const bool live = p < n_prob && q.len_x >= kK && q.len_y >= kK &&
                    ends[p] != start;
  int32_t* mi = match_i + start;
  int32_t* mj = match_j + start;
  int32_t* mp = match_prev + start;
  const int n_i = live ? q.len_x - kK + 1 : 0, n_j = q.len_y - kK + 1;
  Link links[kLinks];
#pragma unroll
  for (int k = 0; k < kLinks; ++k) links[k] = Link{INT32_MAX, 0, 0};
  int ci = 0, cj = 0, ck = 0, filled = 0;
  int blk = 0, i0 = 0, run_lo = 0, excl = 0, total = 0, m0 = 0;
  long long base = 0, best_a = -1;
  int best_sc = -1;
  unsigned sum = 0;
  while (true) {
    // fill each group's chunk: G matches, or what its reads have left
    while (true) {
      const bool need = filled < G && m0 >= total && i0 < n_i;
      if (!__any_sync(kFull, need || (filled < G && m0 < total))) break;
      int lo = 0, hi = 0;
      if (need) lookup(q, i0 + gl, n_i, n_j, lo, hi);
      int incl = hi - lo;
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d, G);
        if (gl >= d) incl += v;
      }
      const int tot = __shfl_sync(kFull, incl, G - 1, G);
      if (need) {
        run_lo = lo;
        excl = incl - (hi - lo);
        total = tot;
        m0 = 0;
        blk = i0;
        i0 += G;
      }
      const int take = filled < G ? min(total - m0, G - filled) : 0;
      const int m = m0 + gl - filled;
      int src = 0;
#pragma unroll
      for (int b = G / 2; b > 0; b >>= 1) {
        if (__shfl_sync(kFull, excl, src + b, G) <= m) src += b;
      }
      const int e = __shfl_sync(kFull, run_lo, src, G) +
                    (m - __shfl_sync(kFull, excl, src, G));
      if (take > 0 && gl >= filled && gl < filled + take) {
        ci = blk + src;
        cj = __ldg(q.pos + e);
      }
      if (take > 0) {
        filled += take;
        m0 += take;
      }
    }
    const int n = filled;
    if (!__any_sync(kFull, n > 0)) break;
    chunk[warp][lane] = make_int2(ci, cj);
    __syncwarp();
    const int steps = __reduce_max_sync(kFull, n);
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const int2 a = chunk[warp][gbase + t];
      int key = link_key<int>(links[0], (gl - t) & (kMaxPred - 1), a.x, a.y);
#pragma unroll
      for (int k = 1; k < kLinks; ++k) {
        key = max(key, link_key<int>(links[k], kMaxPred - G * k + gl - t,
                                     a.x, a.y));
      }
      int top = 0;
#pragma unroll
      for (int r = 0; r < kGroups; ++r) {
        const int v = __reduce_max_sync(kFull, g == r ? key : 0);
        top = g == r ? v : top;
      }
      const int sc = key_score(top);
      const bool mine = gl == t && t < n;
      links[0].i = mine ? ci : links[0].i;
      links[0].j = mine ? cj : links[0].j;
      links[0].sc = mine ? sc : links[0].sc;
      ck = mine ? top : ck;
    }
    // the chunk's first match of its greatest score, if above the best
    int top = -1;
#pragma unroll
    for (int r = 0; r < kGroups; ++r) {
      const int v = __reduce_max_sync(
          kFull, g == r && gl < n ? links[0].sc : -1);
      top = g == r ? v : top;
    }
    const unsigned first =
        (__ballot_sync(kFull, gl < n && links[0].sc == top) >> gbase) &
        (G == 32 ? kFull : (1u << G) - 1);
    if (n > 0 && top > best_sc) {
      best_sc = top;
      best_a = base + __ffs(first) - 1;
    }
    if (gl < n) {
      const int dist = key_distance(ck);
      mi[base + gl] = ci;
      mj[base + gl] = cj;
      mp[base + gl] = dist;
      sum += static_cast<unsigned>(dist) *
             static_cast<unsigned>(base + gl + 1);
    }
    const Link oldest = links[kLinks - 1];
#pragma unroll
    for (int k = kLinks - 1; k > 0; --k) links[k] = links[k - 1];
    links[0] = oldest;
    base += n;
    filled = 0;
    __syncwarp();
  }
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d, G);
  if (p < n_prob && gl == 0) {
    best_out[p] = best_a;
    sum_out[p] = sum;
  }
}

__global__ void __launch_bounds__(kProbeThreads)
warp_dp_check(const uint8_t* __restrict__ reads, size_t n_prob, int lx,
              int ly, const int32_t* __restrict__ idx_ref,
              const int32_t* __restrict__ idx_alt, int per_read,
              const unsigned long long* __restrict__ keys,
              const int32_t* __restrict__ pos,
              const int32_t* __restrict__ hap_len,
              const long long* __restrict__ ends, int32_t* match_i,
              int32_t* match_j, int32_t* match_prev,
              long long* __restrict__ best_out,
              unsigned* __restrict__ sum_out) {
  __shared__ Ring rings[kProbeWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t p = static_cast<size_t>(blockIdx.x) * kProbeWarps + warp;
  if (p >= n_prob) return;
  const Problem q = load_problem(reads, lx, ly, idx_ref, idx_alt, per_read,
                                 keys, pos, hap_len, p);
  const long long start = p ? ends[p - 1] : 0;
  long long best = -1;
  unsigned sum = 0;
  if (q.len_x >= kK && q.len_y >= kK && ends[p] != start) {
    const Chain ch = chain_dp<int>(q, ends, p, 0, match_i, match_j,
                                   match_prev, rings[warp]);
    const long long in_ring = (ch.count + 31) / 32 - kRing;
    for (long long a = lane; a < ch.count; a += 32) {
      const long long c = a / 32;
      const int d = c >= in_ring
                        ? rings[warp].dist[c & (kRing - 1)][a & 31]
                        : ch.prev[a];
      sum += static_cast<unsigned>(d) * static_cast<unsigned>(a + 1);
    }
    best = ch.best;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
  if (lane == 0) {
    best_out[p] = best;
    sum_out[p] = sum;
  }
}

// lanes: 0 for warp_dp_check, else G of group_dp_probe; 0 = ok
extern "C" int mapping_probe_launch(
    int lanes, const void* reads, int n_reads, int lx, int ly,
    const void* idx_ref, const void* idx_alt, int per_read, const void* keys,
    const void* pos, const void* hap_len, const void* ends, void* match_i,
    void* match_j, void* match_prev, void* best_out, void* sum_out,
    void* stream) {
  const size_t n_prob = per_read * static_cast<size_t>(n_reads);
  const size_t per_block = kProbeWarps * (lanes ? 32 / lanes : 1);
  const unsigned blocks =
      static_cast<unsigned>((n_prob + per_block - 1) / per_block);
  auto launch = [&](auto kernel) {
    kernel<<<blocks, kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), n_prob, lx, ly,
        static_cast<const int32_t*>(idx_ref),
        static_cast<const int32_t*>(idx_alt), per_read,
        static_cast<const unsigned long long*>(keys),
        static_cast<const int32_t*>(pos),
        static_cast<const int32_t*>(hap_len),
        static_cast<const long long*>(ends), static_cast<int32_t*>(match_i),
        static_cast<int32_t*>(match_j), static_cast<int32_t*>(match_prev),
        static_cast<long long*>(best_out), static_cast<unsigned*>(sum_out));
  };
  switch (lanes) {
    case 0: launch(warp_dp_check); break;
    case 32: launch(group_dp_probe<32>); break;
    case 16: launch(group_dp_probe<16>); break;
    case 8: launch(group_dp_probe<8>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
'''
MAPPING_LANES = (32, 16, 8)
MAIN_LX, MAIN_LY, MAIN_READS = 160, 224, 65536
E2E_CFG = dict(n_chroms=4, chrom_len=200_000, n_variants=1000, n_cells=2000,
               reads_per_variant=500, spliced_frac=0.5, seed=100)
# phase 5's N dataset: its reads with one base set to N in a seeded 1 %
# of them (about the share of Illumina reads that carry an N)
N_READ_FRAC, N_READ_SEED = 0.01, 101
# phase 7's --host python dataset: phase 5's widths with a tenth of its
# variants (50,000 reads), cut because the Python record path decodes and
# joins every record in Python
PY_HOST_CFG = dict(E2E_CFG, n_variants=100)
# every launch counter of ops/sw_cuda in the port's recorder
# (utils/trace.counters, "launch.<kind>"): driver._main zeroes them at its
# start, so a phase reads them after a run, or as the difference over
# direct wrapper calls
LAUNCH_KINDS = ("sw_pair.pair", "sw_pair.rows", "sw_banded.pair",
                "sw_banded.rows", "band_build.pair", "band_build.rows",
                "band_index")
SW_PAIR = ("sw_pair.pair", "sw_pair.rows")
# phase 6: a sparse whole-genome-like dataset, bench.py COHORT_CFG's genome
# (16 x 4 Mb) with ~6 variants and ~20,000 background reads per Mb
SPARSE_CFG = dict(n_chroms=16, chrom_len=4_000_000, n_variants=400,
                  n_cells=5000, reads_per_variant=250,
                  background_reads=1_300_000, spliced_frac=0.3, seed=2026)
SPARSE_WINDOW = 50  # --stream N of phase 6
# runs `python -m vartrix_tpu_torch ARGS` in a process of its own and prints
# to its stderr the process's peak RSS (ru_maxrss), which start-up (torch,
# the CUDA context, sw_pair's library) sets on the card's machine, and the
# RSS once that start-up is done and its peak over the run, sampled from
# /proc/self/statm every 5 ms on a thread of its own
RSS_WRAPPER = (
    "import resource, runpy, sys, threading, torch\n"
    "from vartrix_tpu_torch.ops import sw_cuda\n"
    "if torch.cuda.is_available():\n"
    "    torch.zeros(1, device='cuda')\n"
    "    sw_cuda._kernel()\n"
    "def rss():\n"
    "    with open('/proc/self/statm') as f:\n"
    "        return int(f.read().split()[1]) * resource.getpagesize() // 1024\n"
    "start = peak = rss()\n"
    "done = threading.Event()\n"
    "def sample():\n"
    "    global peak\n"
    "    while not done.wait(0.005):\n"
    "        peak = max(peak, rss())\n"
    "threading.Thread(target=sample, daemon=True).start()\n"
    "try:\n"
    "    runpy.run_module('vartrix_tpu_torch', run_name='__main__', "
    "alter_sys=True)\n"
    "finally:\n"
    "    done.set()\n"
    "    print('peak_rss_kb', resource.getrusage(resource.RUSAGE_SELF)"
    ".ru_maxrss, 'start_rss_kb', start, 'run_peak_rss_kb',\n"
    "          max(peak, rss()), file=sys.stderr)\n")


# --sanitize: phase 3's checks in a child process under compute-sanitizer,
# which sets CHIP_SMOKE_SANITIZE to the tool's name there; cut sizes
SANITIZE = os.environ.get("CHIP_SMOKE_SANITIZE", "")
SANITIZE_TOOLS = ("memcheck", "racecheck", "initcheck", "synccheck")
SANITIZE_MARK = "@@sanitize"
# only this repository's kernels are instrumented (mangled names hold
# these): PyTorch's own kernels, the plain versions', run unchecked
SANITIZE_FILTER = tuple(
    arg for name in ("sw_pair", "sw_banded", "12index_kernel",
                     "19index_shared_kernel", "12count_kernel",
                     "12chain_kernel")
    for arg in ("--kernel-name", f"kns={name}"))
if SANITIZE:
    MAIN_READS = 4096  # the main family: 8,192 problems, not 131,072
LONG_HAP_READS = 64 if SANITIZE else 512  # the 100 kb locus
HOMOPOLYMER_READS = 16 if SANITIZE else 128
# the homopolymer locus's chain-pass scratch budget: its matches need 2+
# ranges (16 reads: ~210 MB of match scratch)
HOMOPOLYMER_BUDGET = (64 << 20) if SANITIZE else None


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------- inputs


def make_family(rng, n_reads, lx, ly, *, read_len, hap_len, err=0.01,
                indels=False, empty_frac=0.0, odd_bytes=False):
    """Seeded reads sampled from haplotype pairs (alt = ref with one
    substitution), with sequencing errors. Returns (x uint8 [R, lx] pad 0,
    haps uint8 [H, ly] pad 1, idx_ref, idx_alt int32 [R])."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    n_var = max(1, n_reads // 64)
    hl = rng.integers(hap_len[0], hap_len[1] + 1, n_var)
    ref = rng.choice(bases, (n_var, ly))
    alt = ref.copy()
    snv = hl // 2
    alt[np.arange(n_var), snv] = bases[(np.searchsorted(
        bases, ref[np.arange(n_var), snv]) + 1) % 4]
    haps = np.ones((2 * n_var, ly), np.uint8)
    cols = np.arange(ly)[None, :]
    haps[0::2] = np.where(cols < hl[:, None], ref, 1)
    haps[1::2] = np.where(cols < hl[:, None], alt, 1)
    if empty_frac:
        haps[rng.random(2 * n_var) < empty_frac] = 1
    if odd_bytes:  # raw-byte compare: lowercase haplotype bases
        low = (rng.random(haps.shape) < 0.02) & (haps != 1)
        haps[low] = haps[low] + 32
    var = rng.integers(0, n_var, n_reads)
    src = 2 * var + rng.integers(0, 2, n_reads)
    L = np.minimum(rng.integers(read_len[0], read_len[1] + 1, n_reads),
                   np.minimum(hl[var], lx))
    L = np.maximum(L, 1)
    off = (rng.random(n_reads) * (hl[var] - L + 1)).astype(np.int64)
    pos = np.minimum(off[:, None] + np.arange(lx)[None, :], ly - 1)
    x = haps[src[:, None], pos]
    x = np.where(x == 1, bases[0], x)  # reads of empty haplotypes
    x = np.where((x >= 97), x - 32, x)  # reads are uppercase
    errs = rng.random(x.shape) < err
    x[errs] = rng.choice(bases, int(errs.sum()))
    if odd_bytes:
        x[rng.random(x.shape) < 0.01] = ord("N")
        x[rng.random(x.shape) < 0.01] = ord("=")
    x[np.arange(lx)[None, :] >= L[:, None]] = 0
    if indels:
        for i in range(n_reads):
            row = list(x[i, : L[i]])
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(1, max(2, len(row) - 1)))
                if rng.random() < 0.5:
                    del row[p : p + int(rng.integers(1, 5))]
                else:
                    row[p:p] = list(rng.choice(bases, int(rng.integers(1, 5))))
            row = row[:lx]
            x[i] = 0
            x[i, : len(row)] = row
    idx_ref = (2 * var).astype(np.int32)
    idx_alt = (2 * var + 1).astype(np.int32)
    return x, haps, idx_ref, idx_alt


def k5_family(rng):
    """The interleaved-index entry of the chained TPU kernel K5: each read
    owns two of 2R haplotype rows, listed as idx2 (ref, alt, ref, alt, ...)
    in a shuffled order; idx_ref = idx2[0::2], idx_alt = idx2[1::2]."""
    import numpy as np

    x, haps, ir, ia = make_family(rng, 4096, 16, 48, read_len=(1, 16),
                                  hap_len=(1, 48))
    rows = haps[np.stack([ir, ia], axis=1).reshape(-1)]
    idx2 = rng.permutation(len(rows)).astype(np.int32)
    shuffled = np.empty_like(rows)
    shuffled[idx2] = rows
    return x, shuffled, idx2[0::2].copy(), idx2[1::2].copy()


def mixed_gap_family():
    """Adversarial gap corners: one read base against t haplotype bases."""
    import numpy as np

    cases = []
    for flank in (6, 10, 14):
        for ins in (1, 2, 3):
            a = b"A" * flank + b"C" + b"G" * flank
            b = b"A" * flank + b"T" * (ins + 1) + b"G" * flank
            cases += [(a, b), (b, a)]
    lx, ly = 48, 64
    x = np.zeros((len(cases), lx), np.uint8)
    haps = np.ones((2 * len(cases), ly), np.uint8)
    for i, (a, b) in enumerate(cases):
        x[i, : len(a)] = np.frombuffer(a, np.uint8)
        haps[2 * i, : len(b)] = np.frombuffer(b, np.uint8)
        haps[2 * i + 1, : len(a)] = np.frombuffer(a, np.uint8)
    idx = np.arange(len(cases), dtype=np.int32)
    return x, haps, 2 * idx, 2 * idx + 1


def pack2(x):
    """uint8 [R, lx] A/C/G/T reads -> (uint8 [R, lx//4], int32 [R])."""
    import numpy as np

    lut = np.zeros(256, np.uint8)
    for c, b in enumerate(b"ACGT"):
        lut[b] = c
    codes = lut[x]
    out = np.zeros((x.shape[0], x.shape[1] // 4), np.uint8)
    for k in range(4):
        out |= codes[:, k::4] << (2 * k)
    return out, (x != 0).sum(1).astype(np.int32)


NT16 = b"=ACMGRSVTWYHKDBN"  # BAM's 4-bit symbols, by code


def pack4(x):
    """uint8 [R, lx] reads of BAM's 16 symbols (pad 0; lx even) -> (uint8
    [R, lx//2] nibbles, high first, int32 [R] lengths)."""
    import numpy as np

    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(NT16, np.uint8)] = np.arange(16, dtype=np.uint8)
    codes = lut[x]
    return ((codes[:, 0::2] << 4) | codes[:, 1::2],
            (x != 0).sum(1).astype(np.int32))


def nt16_only(x):
    """Whether every read byte of x lies in BAM's 16 symbols and its width
    is even: the 4-bit entry takes it."""
    import numpy as np

    return x.shape[1] % 2 == 0 and bool(np.isin(
        x[x != 0], np.frombuffer(NT16, np.uint8)).all())


def true_cells(x, haps, idx_ref, idx_alt, strip=1):
    """Sum over (read, haplotype) pairs of true read length (rounded up to
    `strip` rows) x true haplotype length."""
    import numpy as np

    lx_true = (x != 0).sum(1).astype(np.int64)
    lx_true = (lx_true + strip - 1) // strip * strip
    h_true = (haps != 1).sum(1).astype(np.int64)
    return int((lx_true * (h_true[idx_ref] + h_true[idx_alt])).sum())


def near_limit_family(rng):
    """One read of 32,842 bases against a 32,840-base haplotype it copies
    with a 2-base insertion that spans a 16-row strip boundary after 32,783
    matched bases, so F near the top of the scratch word's range crosses
    the boundary. The alt haplotype has one substitution at base 100.
    Scores are known: n - 7 (ref) and n - 13 (alt)."""
    import numpy as np

    n, p = 32840, 16 * 2049 - 1
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = rng.choice(bases, n)
    read = np.concatenate([hap[:p], np.frombuffer(b"AC", np.uint8), hap[p:]])
    alt = hap.copy()
    alt[100] = bases[(np.searchsorted(bases, alt[100]) + 1) % 4]
    idx = np.zeros(1, np.int32)
    return (read[None, :], np.stack([hap, alt]), idx, idx + 1,
            [[n - 7, n - 13]])


def packed_limit_family(rng):
    """Reads at min(lx, ly) = 32,767, the packed route's edge (lx = 32,768,
    ly = 32,767), against a 32,767-base haplotype and its alt, the same
    with base 32,700 deleted: the haplotype itself (ref n = 32,767, alt
    n - 7: one base fewer and a 1-base gap near the end), the haplotype
    with 2 bases inserted after base 32,750 and cut to n (n - 9, n - 16),
    the alt (n - 7, n - 1) and the haplotype from base 1 (n - 1, n - 8).
    Known scores per read as [ref, alt]."""
    import numpy as np

    n, p = 32767, 32700
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = rng.choice(bases, n)
    alt = np.concatenate([hap[:p], hap[p + 1 :]])
    haps = np.ones((2, n), np.uint8)
    haps[0] = hap
    haps[1, : n - 1] = alt
    reads = [hap, np.concatenate([hap[:32750], np.frombuffer(b"AC", np.uint8),
                                  hap[32750 : n - 2]]), alt, hap[1:]]
    x = np.zeros((len(reads), n + 1), np.uint8)
    for i, r in enumerate(reads):
        x[i, : len(r)] = r
    idx = np.zeros(len(reads), np.int32)
    known = [[n, n - 7], [n - 9, n - 16], [n - 7, n - 1], [n - 1, n - 8]]
    return x, haps, idx, idx + 1, known


def packed4_family(rng, n_reads=4096):
    """4-bit reads at the main shape (lx 160, ly 224): odd and even read
    lengths, N, '=' and IUPAC bytes at seeded positions (about 2 % of
    bases), and a read of length 0 (read 0)."""
    import numpy as np

    x, haps, ir, ia = make_family(rng, n_reads, MAIN_LX, MAIN_LY,
                                  read_len=(1, MAIN_LX), hap_len=(1, MAIN_LY))
    odd = (rng.random(x.shape) < 0.02) & (x != 0)
    x[odd] = rng.choice(np.frombuffer(b"N=RYKMSWBDHV", np.uint8),
                        int(odd.sum()))
    x[0] = 0
    return x, haps, ir, ia


def packed4_limit_family(rng, width):
    """4-bit reads in a bucket of lx = ly = width, a route's limit, at few
    cells: haplotype 0 of `width` bases; 1 and 2 two 224-base windows of
    it, each with a substitution; reads: haplotype 0 whole with IUPAC bytes
    against (1, 2), 151 bases of haplotype 0's end against (0, 1), an
    empty read against (0, 2), and 149 bases of haplotype 1 with N and '='
    against (1, 0)."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    iupac = np.frombuffer(b"N=RYKMSWBDHV", np.uint8)
    hap = rng.choice(bases, width)
    haps = np.ones((3, width), np.uint8)
    haps[0] = hap
    for h, at in ((1, 1000), (2, width - 224)):
        haps[h, :224] = hap[at : at + 224]
        haps[h, 100] = bases[(np.searchsorted(bases, haps[h, 100]) + 1) % 4]
    x = np.zeros((4, width), np.uint8)
    x[0] = hap
    x[0, rng.integers(0, width, 64)] = rng.choice(iupac, 64)
    x[1, :151] = hap[width - 151 :]
    x[3, :149] = haps[1, 30:179]
    x[3, [7, 77, 140]] = np.frombuffer(b"N=N", np.uint8)
    return (x, haps, np.array([1, 0, 0, 1], np.int32),
            np.array([2, 1, 2, 0], np.int32))


def wide_full_family(rng, n_reads=4, n=65600, ly=70000):
    """Reads of n + 2 bases, each the first n bases of a 70,000-base
    haplotype with a 2-base insertion just before a 16-row strip boundary
    (at a different depth per read); the alt haplotype has one substitution
    at base 100. Known scores n - 7 (ref) and n - 13 (alt), above 65,535:
    min(lx, ly) >= 65536 takes the kernels' 64-bit scratch word."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = rng.choice(bases, ly)
    alt = hap.copy()
    alt[100] = bases[(np.searchsorted(bases, alt[100]) + 1) % 4]
    x = np.zeros((n_reads, n + 4), np.uint8)  # lx a multiple of 4 (2-bit)
    for r in range(n_reads):
        p = 16 * (1025 + 1024 * r) - 1
        x[r, : n + 2] = np.concatenate(
            [hap[:p], np.frombuffer(b"AC", np.uint8), hap[p:n]])
    idx = np.zeros(n_reads, np.int32)
    return x, np.stack([hap, alt]), idx, idx + 1, [n - 7, n - 13]


def long_hap_family(rng, n_reads=512, lx=160, ly=100_000):
    """512 reads of 140-150 bases (1 % errors) sampled from a
    100,000-base haplotype and from its alt, the same with 50 bases
    deleted at base 50,000: a long deletion locus, whose DP scratch
    (ly words per problem) and band scratch (thousands of chance 6-mer
    matches per problem) exceed small budgets."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(bases, ly)
    alt = np.concatenate([ref[:50_000], ref[50_050:]])
    haps = np.ones((2, ly), np.uint8)
    haps[0] = ref
    haps[1, : len(alt)] = alt
    x = np.zeros((n_reads, lx), np.uint8)
    lens = rng.integers(140, 151, n_reads)
    for r in range(n_reads):
        src = ref if r % 2 == 0 else alt
        o = int(rng.integers(0, len(src) - lens[r] + 1))
        if r % 8 == 1:  # reads across the deletion point
            o = 50_000 - int(rng.integers(10, lens[r] - 10))
        x[r, : lens[r]] = src[o : o + lens[r]]
    err = (rng.random(x.shape) < 0.01) & (x != 0)
    x[err] = rng.choice(bases, int(err.sum()))
    idx = np.zeros(n_reads, np.int32)
    return x, haps, idx, idx + 1


def parted_family(rng, n_reads=4096, lx=160, ly=224, indel=60):
    """Reads of 140-150 bases (1 % errors) across a 60-base deletion (even
    variants: a 224-base ref) or insertion (odd: a 164-base ref) at the
    middle of the ref, sampled from the ref or the alt: on one side of the
    indel a read's ref and alt bands lie 60 columns apart, more than a
    band's width (~41), so a packed thread's two bands do not meet there."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    n_var = max(1, n_reads // 64)
    haps = np.ones((2 * n_var, ly), np.uint8)
    for v in range(n_var):
        ref = rng.choice(bases, ly if v % 2 == 0 else ly - indel)
        mid = len(ref) // 2
        alt = (np.concatenate([ref[:mid], ref[mid + indel :]]) if v % 2 == 0
               else np.concatenate([ref[:mid], rng.choice(bases, indel),
                                    ref[mid:]]))
        haps[2 * v, : len(ref)] = ref
        haps[2 * v + 1, : len(alt)] = alt
    var = rng.integers(0, n_var, n_reads)
    x = np.zeros((n_reads, lx), np.uint8)
    for r in range(n_reads):
        src = haps[2 * var[r] + int(rng.integers(0, 2))]
        src = src[src != 1]
        n = min(int(rng.integers(140, 151)), len(src))
        mid = len(src) // 2
        o = int(np.clip(mid - int(rng.integers(20, n - 20)), 0,
                        len(src) - n))
        x[r, :n] = src[o : o + n]
    err = (rng.random(x.shape) < 0.01) & (x != 0)
    x[err] = rng.choice(bases, int(err.sum()))
    idx = (2 * var).astype(np.int32)
    return x, haps, idx, idx + 1


def unseeded_family(rng, n_reads, lx, ly):
    """Reads over A/C with a C at every fifth base against haplotypes over
    A/G: no shared 6-mer, so every band is empty and every score 0."""
    import numpy as np

    x = rng.choice(np.frombuffer(b"AC", np.uint8), (n_reads, lx))
    x[:, ::5] = ord("C")
    x[np.arange(lx)[None, :] >= rng.integers(6, lx + 1, n_reads)[:, None]] = 0
    haps = rng.choice(np.frombuffer(b"AG", np.uint8), (2 * n_reads, ly))
    haps[np.arange(ly)[None, :] >= rng.integers(6, ly + 1, 2 * n_reads)[
        :, None]] = 1
    idx = np.arange(n_reads, dtype=np.int32)
    return x, haps, 2 * idx, 2 * idx + 1


def wide_family(rng):
    """One 150-base read copied, with two substitutions, from bases
    36,000-36,150 of a 40,000-base haplotype (the alt has one more
    substitution): its band lies past the int16 range of 32,767."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = rng.choice(bases, 40000)
    read = hap[36000:36150].copy()
    for p in (40, 100):
        read[p] = bases[(np.searchsorted(bases, read[p]) + 1) % 4]
    alt = hap.copy()
    alt[36075] = bases[(np.searchsorted(bases, alt[36075]) + 2) % 4]
    x = np.zeros((1, 160), np.uint8)
    x[0, :150] = read
    idx = np.zeros(1, np.int32)
    return x, np.stack([hap, alt]), idx, idx + 1


def repetitive_family(rng, n_reads=256, lx=64, ly=128):
    """Low-complexity reads and haplotypes (short tandem repeats of one to
    three bases, the alt with a few substitutions): thousands of 6-mer
    matches per problem, up to (len_x - 5)(len_y - 5)."""
    import numpy as np

    units = [b"A", b"AC", b"ACG", b"AAC", b"CA", b"TTG"]
    bases = np.frombuffer(b"ACGT", np.uint8)
    x = np.zeros((n_reads, lx), np.uint8)
    haps = np.ones((2 * n_reads, ly), np.uint8)
    for r in range(n_reads):
        unit = np.frombuffer(units[r % len(units)], np.uint8)
        n = int(rng.integers(lx // 2, lx + 1))
        x[r, :n] = np.resize(unit, n)
        for h in (2 * r, 2 * r + 1):
            m = int(rng.integers(ly // 2, ly + 1))
            haps[h, :m] = np.resize(unit, m)
            if h % 2:
                haps[h, rng.integers(0, m, 3)] = rng.choice(bases, 3)
    idx = np.arange(n_reads, dtype=np.int32)
    return x, haps, 2 * idx, 2 * idx + 1


def strip_stats(lens, jlo, jhi, ly, packed=False):
    """What sw_banded.cu does with its strips of STRIP rows on these
    bounds (its zone rule, in numpy): (visited problem cells, core problem
    cells, share of lane slots its warps leave idle). lens: each problem's
    true read length. A strip visits [c0, c1), the union of its in-band
    rows; its core is [max jlo, min jhi) over its rows below the read's
    true length, clipped to [c0, c1). On the scalar routes a thread holds
    one problem and a warp runs each of a strip's three zones (entry,
    core, exit) as long as its widest lane. On the packed route (packed)
    thread k holds problems 2k and 2k + 1, its strips take the union and
    the intersection over both, and a warp's lanes with a cell in the
    strip run its zones together in steps of two columns from their c0:
    the entry zone to the widest lane's core start, the core to the
    narrowest lane's core end, the exit zone to the widest lane's c1;
    each column a lane visits is a cell of both problems."""
    import numpy as np

    lx, P = jlo.shape
    h = 2 if packed else 1
    T = -(-P // (32 * h)) * 32  # threads, whole warps
    n = -(-lx // STRIP) * STRIP
    lo = np.zeros((n, T * h), np.int64)
    hi = np.zeros((n, T * h), np.int64)
    lo[:lx, :P], hi[:lx, :P] = jlo, jhi
    length = np.zeros(T * h, np.int64)
    length[:P] = lens
    lo = lo.reshape(n // STRIP, STRIP, T, h)
    hi = hi.reshape(n // STRIP, STRIP, T, h)
    band = lo < hi
    live = (np.arange(n).reshape(-1, STRIP)[:, :, None, None]
            < length.reshape(T, h)[None, None])
    c0 = np.maximum(np.where(band, lo, ly).min((1, 3)), 0)
    c1 = np.minimum(np.where(band, hi, 0).max((1, 3)), ly)
    a = np.maximum(c0, np.minimum(np.where(live, lo, 0).max((1, 3)), c1))
    b = np.maximum(a, np.minimum(np.where(live, hi, ly).min((1, 3)), c1))
    run = c0 < c1

    def warps(v):  # [strips, warps, 32]
        return v.reshape(v.shape[0], -1, 32)

    if packed:
        on = warps(run)
        entry = np.where(on, warps(-(-(a - c0) // 2)), 0).max(2)
        core = np.maximum(np.where(on, warps((b - c0) // 2), 1 << 40)
                          .min(2), entry)
        steps = np.where(on, warps(-(-(c1 - c0) // 2)), 0).max(2)
        lanes = on.sum(2)
        return (2 * STRIP * h * int((lanes * steps).sum()),
                2 * STRIP * h * int((lanes * (core - entry)).sum()),
                1 - (lanes * steps).sum() / (32 * steps.sum())
                if steps.any() else 0.0)
    zones = [np.where(run, z, 0) for z in (a - c0, b - a, c1 - b)]
    cols = sum(zones)
    warp_cols = sum(warps(z).max(axis=2).sum() for z in zones)
    return (STRIP * int(cols.sum()), STRIP * int(zones[1].sum()),
            1 - cols.sum() / (32 * warp_cols) if warp_cols else 0.0)


def homopolymer_locus(rng, n_reads=128, lx=160, ly=4032):
    """Reads of one homopolymer locus (a 4,000-base run of A, the alt
    with a few substitutions), 140-150 bases each, some with an error:
    about (len_x - 5)(len_y - 5) = 600,000 matches per problem, more than
    one chain-pass range of the band builder's scratch budget holds."""
    import numpy as np

    haps = np.ones((2, ly), np.uint8)
    haps[:, :4000] = ord("A")
    haps[1, rng.integers(0, 4000, 4)] = ord("C")
    x = np.zeros((n_reads, lx), np.uint8)
    lens = rng.integers(140, 151, n_reads)
    for r in range(n_reads):
        x[r, : lens[r]] = ord("A")
        if r % 3 == 0:
            x[r, rng.integers(0, lens[r])] = ord("G")
    idx = np.zeros(n_reads, np.int32)
    return x, haps, idx, idx + 1


def match_counts(xt, ht, irt, iat):
    """int64 [2R] 6-mer matches of each problem (read r against idx_ref[r]
    and idx_alt[r]), counted on the card with the plain builder's keys."""
    import torch

    from vartrix_tpu_torch.ops import band_torch

    len_x = band_torch.true_lengths(xt, 0)
    len_y = band_torch.true_lengths(ht, 1)
    kx = band_torch.kmer_keys(xt, len_x, -1)
    ky = band_torch.kmer_keys(ht, len_y, -2)
    idx = torch.stack([irt, iat], 1).reshape(-1).long()
    P = idx.shape[0]
    out = torch.empty(P, dtype=torch.int64, device=xt.device)
    g = max(1, (1 << 28) // max(kx.shape[1] * ky.shape[1], 1))
    for s in range(0, P, g):
        p = torch.arange(s, min(P, s + g), device=xt.device)
        out[p] = (kx[p // 2][:, :, None] == ky[idx[p]][:, None, :]).sum(
            (1, 2))
    return out


# ---------------------------------------------------------------- phases


def phase_card():
    """(name and power limit as nvidia-smi prints them, max SM clock Hz)."""
    import torch

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.splitlines()[0].strip()

    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    log(f"card: {card}, max SM clock {clock_mhz:.0f} MHz")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return card, clock_mhz * 1e6


def build_probe(name, source, kind="-cubin"):
    """`source` compiled for sm_90a into build/chip_smoke_probe/: a cubin
    (SASS only) or, kind "-shared", a library to load with ctypes; returns
    its path."""
    from vartrix_tpu_torch.ops import _build

    out_dir = os.path.join(HERE, "build", "chip_smoke_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source)
    out = os.path.join(out_dir, name + (".cubin" if kind == "-cubin"
                                        else ".so"))
    flags = ["-Xcompiler", "-fPIC"] if kind == "-shared" else []
    subprocess.run([_build._nvcc(), kind, *flags, "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", os.path.dirname(_build.BAND_BUILD_SRC), "-o", out,
                    src], check=True, capture_output=True, text=True)
    return out


def registers(library, symbol):
    """The registers ptxas reports for the kernel function `symbol`."""
    from vartrix_tpu_torch.ops import _build

    lines = _build.build_log(library).splitlines()
    for i, line in enumerate(lines):
        if "entry function" in line and symbol in line:
            for nxt in lines[i + 1 : i + 4]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    return int(m.group(1))
    fail(f"no register report for {symbol}")


def phase_build():
    """Builds every library at once; returns the three kernels' paths, the
    two SASS probes', the DPX rate probe's, those of band_build's split
    (the chain DP, lookups and mapping probes) and the empty kernel's."""
    from vartrix_tpu_torch.ops import _build

    t0 = time.perf_counter()
    builders = (_build.kernel_library, _build.banded_kernel_library,
                _build.band_build_library, _build.genomio_library,
                _build.band_bounds_library, _build.cramio_library,
                lambda: build_probe("candidate_probe", PROBE_SRC),
                lambda: build_probe("cell_probe", CELL_PROBE_SRC),
                lambda: build_probe("dpx_rate", DPX_RATE_SRC, "-shared"),
                lambda: build_probe("chain_dp_probe", product_probe_source(
                    _build.BAND_BUILD_SRC), "-shared"),
                lambda: build_probe("lookups_probe", product_probe_source(
                    _build.BAND_BUILD_SRC, lookups=True), "-shared"),
                lambda: build_probe("mapping_probe", MAPPING_PROBE_SRC,
                                    "-shared"),
                lambda: build_probe("empty_probe", EMPTY_SRC, "-shared"),
                lambda: build_probe("nibble_probe", NIBBLE_PROBE_SRC))
    with ThreadPoolExecutor(max_workers=len(builders)) as ex:
        futures = [ex.submit(b) for b in builders]
        paths = [f.result() for f in futures]
    log(f"build: sw_pair.cu + sw_banded.cu + band_build.cu + genomio.cpp + "
        f"band_bounds.cpp + cramio.cpp + the candidate, cell, DPX rate, "
        f"chain DP, lookups, mapping, empty kernel and nibble probes in "
        f"{time.perf_counter() - t0:.2f}s")
    log("  libcramio: " + _build.build_log(paths[5]).splitlines()[0])
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"  nvcc: {nvcc[-1]}")
    for path in paths[:3]:
        for line in _build.build_log(path).splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  ptxas {os.path.basename(path)}: {line.strip()}")
    return paths[:3] + paths[6:]


def sass_loops(kern_path, symbol, opcode):
    """The innermost loops of one kernel function's SASS that hold
    `opcode`: a list of (instructions, count of opcode, opcode histogram).
    A loop is a backward branch; innermost, it holds no other."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = (shutil.which("cuobjdump")
            or os.path.join(cuda_home, "bin", "cuobjdump"))
    sass = subprocess.run([tool, "-sass", kern_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = [f for f in funcs if f.startswith("_Z") and symbol in f]
    if len(body) != 1:
        fail(f"cuobjdump shows no single {symbol} function among "
             + ", ".join(f.split(None, 1)[0] for f in funcs[1:]))
    instrs = [(int(a, 16), op.strip()) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body[0])]
    spans = []
    for addr, op in instrs:
        m = re.search(r"\bBRA 0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    out = []
    for t, a in spans:
        if any(o != (t, a) and t <= o[0] and o[1] <= a for o in spans):
            continue
        loop = [o for ad, o in instrs if t <= ad <= a]
        n = sum(opcode in o for o in loop)
        if n:
            out.append((len(loop), n, collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", o).split()[0] for o in loop)))
    if not out:
        fail(f"no loop holding {opcode} in {symbol}'s SASS")
    return out


def _describe(n_instr, n, hist):
    return (f"{n_instr} instructions for {n} = {n_instr / n:.4f} each; "
            "opcodes " + ", ".join(f"{k} {v}" for k, v in hist.most_common()))


def dpx_count(hist):
    return sum(v for k, v in hist.items() if k.startswith(DPX_OPCODES))


def phase_sass(paths):
    """Instructions per DP cell: the least cell update (the cell probe),
    and for information sw_pair's hot loops (packed: two problem cells per
    marked instruction; scalar) and sw_banded's core and masked loops; per
    chain candidate, the function's own (candidate scoring and one max,
    from the probe) and band_build's DP step (one warp step scores 64
    candidates, so its warp instructions x 32 lanes / 64, for
    information). Returns a dict of them."""
    kern, banded, band, probe, cell_probe = paths[:5]
    n_instr, n, hist = max(sass_loops(kern, MAIN_KERNEL_SYMBOL,
                                      PACKED_CELL_OPCODE),
                           key=lambda t: t[1])
    log(f"sass: {MAIN_KERNEL_SYMBOL} hot loop, per two problems' cell: "
        + _describe(n_instr, n, hist))
    packed = n_instr / (2 * n)
    packed_dpx = dpx_count(hist) / (2 * n)
    format_loops = {}
    for form, sym in PAIR_FORMAT_SYMBOLS.items():
        loop = max(sass_loops(kern, sym, PACKED_CELL_OPCODE),
                   key=lambda t: t[1])
        format_loops[form] = loop[0]
        log(f"sass: {sym} ({form} reads) hot loop: {loop[0]} instructions, "
            f"{loop[0] / (2 * loop[1]):.4f} per problem cell")
    if len(set(format_loops.values())) != 1:
        fail(f"sw_pair's read formats differ in their hot loop: "
             f"{format_loops}")
    n_instr, n, hist = max(sass_loops(kern, SCALAR_KERNEL_SYMBOL,
                                      CELL_OPCODE), key=lambda t: t[1])
    log(f"sass: {SCALAR_KERNEL_SYMBOL} hot loop, per cell: "
        + _describe(n_instr, n, hist))
    scalar = n_instr / n
    steps = {}
    for sym in ("_Z10cell_probe", "_Z15cell_load_probe"):
        loop = min(sass_loops(cell_probe, sym, "LDG"), key=lambda t: t[0])
        free = (loop[2]["LOP3.LUT"] + loop[2]["IMAD.MOV.U32"]
                if sym == "_Z15cell_load_probe" else 0)
        steps[sym] = (loop[0] - free, dpx_count(loop[2]))
        log(f"sass: {sym} loop, per step (two packed cells): "
            + _describe(loop[0], 1, loop[2])
            + (f"; {free} LOP3 and moves not counted" if free else ""))
    cell = (steps["_Z10cell_probe"][0] - steps["_Z15cell_load_probe"][0]) / 4
    unpack = {}
    for sym in ("nibble_word_probe", "nibble_permute_probe",
                "nibble_load_probe"):
        loop = min(sass_loops(paths[10], sym, "LDG"), key=lambda t: t[0])
        unpack[sym] = loop[0]
        log(f"sass: {sym} loop, per byte (two 4-bit bases): "
            + _describe(loop[0], 1, loop[2]))
    forms = {sym: (unpack[sym] - unpack["nibble_load_probe"]) / 2
             for sym in ("nibble_word_probe", "nibble_permute_probe")}
    nibble = min(forms.values())
    if nibble <= 0:
        fail("a nibble probe's loop is no longer than its load probe's")
    log(f"sass: a 4-bit read base's unpack, per base: sw_pair.cu's form "
        f"{forms['nibble_word_probe']:.1f}, byte permutes "
        f"{forms['nibble_permute_probe']:.1f} instructions; charged the "
        f"least, {nibble:.1f}")
    cell_dpx = steps["_Z10cell_probe"][1] / 4
    if cell <= 0:
        fail("the cell probe's loop is no longer than its load probe's")
    log(f"sass: the least cell update {cell:.4f} instructions per problem "
        f"cell ({cell_dpx:.4f} of them DPX); sw_pair's packed loop issues "
        f"{packed:.4f} ({packed_dpx:.4f} DPX), its scalar loop {scalar:.4f}")
    zones = {}
    for route, sym, opcode, per in (
            ("packed", BANDED_KERNEL_SYMBOL, PACKED_CELL_OPCODE, 2),
            ("word32", BANDED_SCALAR_SYMBOL, CELL_OPCODE, 1)):
        loops = sorted(sass_loops(banded, sym, opcode),
                       key=lambda t: t[0] / t[1])
        for name, loop in (("core", loops[0]), ("masked", loops[-1])):
            log(f"sass: {sym} {name} loop, per "
                + ("two problems' cell: " if per == 2 else "cell: ")
                + _describe(*loop))
        zones[route] = tuple(t[0] / (per * t[1])
                             for t in (loops[0], loops[-1]))
    log(f"sass: sw_banded per problem cell, core and masked: packed "
        f"{zones['packed'][0]:.4f} and {zones['packed'][1]:.4f}, word32 "
        f"{zones['word32'][0]:.4f} and {zones['word32'][1]:.4f}; the least "
        f"update {cell:.4f}")
    probe_loops = {}
    for sym in ("_Z15candidate_probe", "_Z10min3_probe", "_Z10load_probe"):
        loop = min(sass_loops(probe, sym, "LDG"), key=lambda t: t[0])
        lop3 = loop[2]["LOP3.LUT"] if sym == "_Z10load_probe" else 0
        probe_loops[sym] = loop[0] - lop3
        log(f"sass: {sym} loop, per iteration: " + _describe(loop[0], 1,
                                                             loop[2])
            + (f"; {lop3} LOP3 not counted" if lop3 else ""))
    forms = {sym: probe_loops[sym] - probe_loops["_Z10load_probe"]
             for sym in ("_Z15candidate_probe", "_Z10min3_probe")}
    per_candidate = min(forms.values())
    if per_candidate <= 0:
        fail("a candidate probe's loop is no longer than the load probe's")
    # the DP step's hot loop: the one of the most warp steps per pass (a
    # full chunk's, unrolled), then the fewest instructions
    n_instr, n, hist = max(sass_loops(band, CHAIN_KERNEL_SYMBOL,
                                      CHAIN_OPCODE),
                           key=lambda t: (t[1], -t[0]))
    log(f"sass: {CHAIN_KERNEL_SYMBOL} DP step, per {CHAIN_OPCODE}: "
        + _describe(n_instr, n, hist))
    log(f"sass: a chain candidate's own work, scoring and one max: "
        f"band_build.cu's candidate {forms['_Z15candidate_probe']}, the "
        f"three-way-minimum form {forms['_Z10min3_probe']} instructions; "
        f"charged the least, {per_candidate}; band_build's DP step issues "
        f"{n_instr / n * 32 / 64:.4f} per candidate (64 per warp step)")
    return dict(cell=cell, cell_dpx=cell_dpx, packed=packed,
                packed_dpx=packed_dpx, scalar=scalar, zones=zones,
                format_loops=format_loops, nibble=nibble,
                per_candidate=per_candidate, chain_step=n_instr / n)


def check_pair_forms(name, x, haps, ir, ia, routes):
    """sw_pair on one family against its plain version, on each of
    `routes`, in every read format its bytes allow: dense, 2-bit (A/C/G/T
    only), 4-bit (BAM's 16 symbols, lx even); int32 scores and int8 codes,
    each packed format also against the dense entry's output on the same
    route. Returns max |err|."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import sw_cuda, sw_torch

    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    plain = sw_torch.pair_scores(xt, ht, irt, iat)
    plain_codes = sw_torch.calls_from_scores(plain)
    forms = [("dense", xt, None, 2)]
    if np.isin(x[x != 0], np.frombuffer(b"ACGT", np.uint8)).all():
        xp, lens = pack2(x)
        forms.append(("2bit", torch.from_numpy(xp).cuda(),
                      torch.from_numpy(lens).cuda(), 2))
    if nt16_only(x):
        xp, lens = pack4(x)
        forms.append(("4bit", torch.from_numpy(xp).cuda(),
                      torch.from_numpy(lens).cuda(), 4))
    worst = 0
    dense = {}
    for form, reads, lens, bits in forms:
        res = []
        for route in routes:
            got = sw_cuda.pair_scores(reads, ht, irt, iat, read_lens=lens,
                                      route=route, read_bits=bits)
            after("sw_pair", name, f"{form} {route} scores")
            codes = sw_cuda.pair_calls(reads, ht, irt, iat, read_lens=lens,
                                       route=route, read_bits=bits)
            after("sw_pair", name, f"{form} {route} codes")
            dense.setdefault(route, (got, codes))
            err = int((got - plain).abs().max().item()) if len(x) else 0
            bad = int((codes != plain_codes).sum().item())
            worst = max(worst, err)
            res.append(f"{route} max|err|={err} code mismatches={bad}")
            if (err or bad or not torch.equal(got, dense[route][0])
                    or not torch.equal(codes, dense[route][1])):
                fail(f"kernel disagrees with the plain version or its dense "
                     f"entry on {name} ({form}, {route})")
        by_width = sw_cuda.pair_route(x.shape[1], haps.shape[1])
        log(f"sw_pair {name:11s} {form:5s} R={len(x)} lx={x.shape[1]} "
            f"ly={haps.shape[1]} ({by_width} by width): " + "; ".join(res))
    return worst


def phase_equality(rng):
    """sw_pair against its plain version on every family, route and read
    format; returns max |err|."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda, sw_torch

    families = {
        "main": make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                            read_len=(140, 150), hap_len=(180, 224)),
        "indel_heavy": make_family(rng, 4096, 64, 96, read_len=(40, 64),
                                   hap_len=(60, 96), err=0.03, indels=True),
        "empty_haps": make_family(rng, 2048, 48, 64, read_len=(20, 48),
                                  hap_len=(30, 64), empty_frac=0.2),
        "odd_r_301": make_family(rng, 301, 32, 48, read_len=(8, 32),
                                 hap_len=(20, 48)),
        "ly_4032": make_family(rng, 4096, 160, 4032, read_len=(140, 150),
                               hap_len=(3800, 4032)),
        "mixed_gap": mixed_gap_family(),
        "n_eq_lower": make_family(rng, 4096, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224),
                                  odd_bytes=True),
        "k5_idx2": k5_family(rng),
        "packed4": packed4_family(rng),
    }
    worst = 0
    for name, (x, haps, ir, ia) in families.items():
        worst = max(worst, check_pair_forms(name, x, haps, ir, ia,
                                            sw_cuda.PAIR_ROUTES))
        if name == "ly_4032":
            wide = (x, haps, ir, ia)
    # 4-bit reads at the packed and word32 routes' limit widths, few cells,
    # on each route that holds them (word64 too; not under --sanitize: the
    # plain version sweeps 65,534 columns)
    for width in () if SANITIZE else (32766, 65534):
        x, haps, ir, ia = packed4_limit_family(rng, width)
        routes = [r for r in sw_cuda.PAIR_ROUTES
                  if r == "word64" or width <= (sw_cuda.PACKED_MAX
                                                if r == "packed" else 65535)]
        t0 = time.perf_counter()
        worst = max(worst, check_pair_forms(f"packed4_{width}", x, haps, ir,
                                            ia, routes))
        log(f"sw_pair packed4_{width}: routes {routes}, "
            f"{time.perf_counter() - t0:.1f} s")
    # the packed route's edge, then near the 32-bit scratch word's limit:
    # against the plain version and the known scores (not under
    # --sanitize: 1 G cells a problem; every family above runs on every
    # route there)
    for fam, route in () if SANITIZE else (
            (packed_limit_family, "packed"), (near_limit_family, "word32")):
        x, haps, ir, ia, known = fam(rng)
        if sw_cuda.pair_route(x.shape[1], haps.shape[1]) != route:
            fail(f"{fam.__name__} does not take the {route} route")
        xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
        t0 = time.perf_counter()
        got = sw_cuda.pair_scores(xt, ht, irt, iat)
        after("sw_pair", fam.__name__, route)
        codes = None
        if route == "packed":
            xp, lens = pack2(x)
            codes = sw_cuda.pair_calls(torch.from_numpy(xp).cuda(), ht, irt,
                                       iat, read_lens=torch.from_numpy(
                                           lens).cuda())
            after("sw_pair", fam.__name__, "2-bit codes")
        dt = time.perf_counter() - t0
        plain = sw_torch.pair_scores(xt, ht, irt, iat)
        got_l, plain_l = got.T.tolist(), plain.T.tolist()
        bad = 0 if codes is None else int(
            (codes != sw_torch.calls_from_scores(plain)).sum().item())
        log(f"sw_pair {fam.__name__[:-7]:11s} dense R={len(x)} "
            f"lx={x.shape[1]} ly={haps.shape[1]} ({route}): kernel {got_l}, "
            f"plain {plain_l}, known {known}"
            + ("" if codes is None else f"; 2-bit code mismatches {bad}")
            + f"; {dt:.1f} s")
        if not got_l == plain_l == known or bad:
            fail(f"kernel disagrees on {fam.__name__} ({route})")
    # the plain (x, y) call of K6: the same kernel with identity indices
    x, haps, ir, ia = wide
    xt = torch.from_numpy(x).cuda()
    yt = torch.from_numpy(haps[ir]).cuda()
    got = sw_cuda.batch_scores(xt, yt)
    after("sw_pair", "k6_rows", sw_cuda.pair_route(x.shape[1], yt.shape[1]))
    exp = sw_torch.sw_scores(xt, yt)
    err = int((got - exp).abs().max().item())
    log(f"sw_pair k6_rows     dense B={len(x)} ly={haps.shape[1]}: "
        f"max|err|={err}")
    if err:
        fail("batch_scores disagrees with the plain version")
    return worst


def start_wide_pair(rng):
    """Launches sw_pair's 64-bit scratch word on wide_full_family, dense
    scores and 2-bit codes, each on a stream of its own (one warp each, for
    a minute or more), so they run beside the rest of phase 3, whose work
    stays on the default stream. Returns finish() -> max |err|: the
    results against the plain version and the known scores."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda, sw_torch

    x, haps, ir, ia, known = wide_full_family(rng)
    if not sw_cuda.wide_word(x.shape[1], haps.shape[1]):
        fail("the wide family does not take the 64-bit scratch word")
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    xp, lens = pack2(x)
    xpt, lt = torch.from_numpy(xp).cuda(), torch.from_numpy(lens).cuda()
    n0 = launch_count(*SW_PAIR)
    streams = [torch.cuda.Stream() for _ in range(2)]
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in streams]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    # the inputs come from the default stream's pool: without these, a
    # tensor freed here (xpt, lt) goes back to that pool while a kernel
    # still reads it, and the next default-stream allocation overwrites it
    for t, st in ((xt, 0), (ht, 0), (irt, 0), (iat, 0), (xpt, 1), (ht, 1),
                  (irt, 1), (iat, 1), (lt, 1)):
        t.record_stream(streams[st])
    with torch.cuda.stream(streams[0]):
        events[0][0].record()
        got = sw_cuda.pair_scores(xt, ht, irt, iat)
        events[0][1].record()
    with torch.cuda.stream(streams[1]):
        events[1][0].record()
        codes = sw_cuda.pair_calls(xpt, ht, irt, iat, read_lens=lt)
        events[1][1].record()
    n = launch_count(*SW_PAIR) - n0

    def finish():
        t0 = time.perf_counter()
        plain = sw_torch.pair_scores(xt, ht, irt, iat)
        sync()
        plain_dt = time.perf_counter() - t0
        for st in streams:
            st.synchronize()
        kernel_s = [a.elapsed_time(b) / 1e3 for a, b in events]
        err = int((got - plain).abs().max().item())
        bad = int((codes != sw_torch.calls_from_scores(plain)).sum().item())
        log(f"sw_pair wide        dense+2bit R={len(x)} lx={x.shape[1]} "
            f"ly={haps.shape[1]} (64-bit scratch word): kernel "
            f"{got.T.tolist()}, known {known} per read, max|err|={err} code "
            f"mismatches={bad}; {n} launches, {kernel_s[0]:.2f} s (scores) "
            f"and {kernel_s[1]:.2f} s (2-bit, codes), each on its own "
            f"stream; plain {plain_dt:.1f} s")
        if err or bad or n != 2 or (got.T.cpu() != torch.tensor(known)).any():
            fail("the 64-bit scratch word disagrees with the plain version "
                 "or the known scores")
        return err

    return finish


def sync():
    """Waits for the default stream's work: phase 3's checks run there,
    beside start_wide_pair's streams."""
    import torch

    torch.cuda.current_stream().synchronize()


AFTER_CALLS = 0  # after() calls so far


def after(kernel, family, route=""):
    """Waits for the default stream's work right after a kernel call of
    phase 3, so that a fault during that call is reported here, naming the
    kernel, its family and route, and not at a later launch (the wrappers'
    cudaGetLastError reports any earlier kernel's sticky error; the wide
    sw_pair launches on their own streams are the one exception, and are
    named). Under --sanitize it also prints the marker that attributes the
    tool's reports since the previous marker to this call."""
    import torch

    global AFTER_CALLS
    AFTER_CALLS += 1
    try:
        torch.cuda.current_stream().synchronize()
    except RuntimeError as e:
        fail(f"CUDA error after {kernel} on {family}"
             + (f" ({route})" if route else "")
             + f" (or in the wide sw_pair launches beside phase 3): {e}")
    if SANITIZE:
        print(f"{SANITIZE_MARK}\t{kernel}\t{family}\t{route or '-'}",
              flush=True)


def index_routes(ly):
    """band_index's routes that hold rows of width ly: the one
    index_route picks first, then the other where it holds them."""
    from vartrix_tpu_torch.ops import sw_cuda

    own = sw_cuda.index_route(ly)
    return [own] + [r for r in sw_cuda.INDEX_ROUTES
                    if r != own and (r == "global"
                                     or ly <= sw_cuda.INDEX_SHARED_LY)]


def check_index(name, ht):
    """band_index on the card against its plain version, on each route
    that holds the width (forced by argument), only the entries the
    kernel writes compared (the first hap_len - 5 of each row); past the
    shared route's width, that route must refuse. Returns (the index of
    the path's route, entries that differ)."""
    import torch

    from vartrix_tpu_torch.ops import band_torch, sw_cuda

    exp = band_torch.band_index(ht)
    n = (exp.hap_len.long() - 5).clamp_min(0)
    valid = torch.arange(ht.shape[1], device=ht.device)[None, :] < n[:, None]
    res, bad, own = [], 0, None
    for route in index_routes(ht.shape[1]):
        got = sw_cuda.band_index(ht, route=route)
        after("band_index", name, route)
        miss = (int((got.hap_len != exp.hap_len).sum().item())
                + int((got.keys[valid] != exp.keys[valid]).sum().item())
                + int((got.pos[valid] != exp.pos[valid]).sum().item()))
        own = got if own is None else own
        bad += miss
        res.append(f"{route} {miss}")
    if ht.shape[1] > sw_cuda.INDEX_SHARED_LY:
        try:
            sw_cuda.band_index(ht, route="shared")
        except RuntimeError:
            res.append("shared refused")
        else:
            fail(f"band_index's shared route took rows of {ht.shape[1]} "
                 "bytes")
    log(f"band_index {name:11s} H={ht.shape[0]} ly={ht.shape[1]}: "
        f"{int(n.sum().item())} keys, mismatches vs plain: "
        + "; ".join(res))
    if bad:
        fail(f"band_index disagrees with the plain version on {name}")
    return own, bad


def index_families(rng):
    """band_index's own families (both banded kernels take the index as
    given): rows at the shared route's limit (ly = INDEX_SHARED_LY, the
    first row with all 8,192 keys a row can have there) and one byte past
    it (the global route alone, the shared refused); rows of one repeated
    base, where every key is equal and only the j order is left, at the
    main width and at the limit. Returns the most mismatches."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    worst = 0
    limit = sw_cuda.INDEX_SHARED_LY
    for name, ly, alphabet, rows in (
            ("index_limit", limit, b"ACGT", 6),
            ("index_past", limit + 1, b"ACGT", 6),
            ("one_base", MAIN_LY, b"A", 64),
            ("one_base_lim", limit, b"A", 3)):
        haps = rng.choice(np.frombuffer(alphabet, np.uint8), (rows, ly))
        lens = rng.integers(0, ly + 1, rows)
        lens[0] = ly
        haps[np.arange(ly)[None, :] >= lens[:, None]] = 1
        _, bad = check_index(name, torch.from_numpy(haps).cuda())
        worst = max(worst, bad)
    return worst


def phase_banded_equality(rng, threads):
    """band_build against its plain version and the host reference, and
    sw_banded against its plain version on the kernel's bounds, on every
    family; returns the max |err| of band_build
    (its bounds against both) and of sw_banded."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import band_torch, sw_cuda, sw_native

    families = {
        "main": make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                            read_len=(140, 150), hap_len=(180, 224)),
        "indel_heavy": make_family(rng, 4096, 64, 96, read_len=(40, 64),
                                   hap_len=(60, 96), err=0.03, indels=True),
        "short_pairs": make_family(rng, 2048, 16, 32, read_len=(1, 8),
                                   hap_len=(1, 12)),
        "unseeded": unseeded_family(rng, 2048, 48, 64),
        "empty_haps": make_family(rng, 2048, 48, 64, read_len=(20, 48),
                                  hap_len=(30, 64), empty_frac=0.2),
        "n_eq_lower": make_family(rng, 4096, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224),
                                  odd_bytes=True),
        "ly_4032": make_family(rng, 4096, 160, 4032, read_len=(140, 150),
                               hap_len=(3800, 4032)),
        "wide_40000": wide_family(rng),
        "repetitive": repetitive_family(rng),
        "parted": parted_family(rng),
    }
    worst = band_worst = index_worst = rows_band = rows_worst = 0
    for name, (x, haps, ir, ia) in families.items():
        host = sw_native.band_bounds(x, haps, ir, ia, threads)
        xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
        index, bad = check_index(name, ht)
        index_worst = max(index_worst, bad)
        got = sw_cuda.band_bounds(xt, ht, irt, iat, index)
        after("band_build", name, sw_cuda.band_route(x.shape[1]))
        plain = band_torch.band_bounds(xt, ht, irt, iat)
        sync()
        bad = sum(int((g.cpu().numpy() != h).sum()) + int((g != q).sum().item())
                  for g, h, q in zip(got, host, plain))
        if name in ("main", "repetitive"):
            # the 64-bit chain keys and the global-work route, each forced
            # by its width threshold, against the 32-bit keys in shared
            # memory (the route this width takes)
            saved = sw_cuda.BAND_WIDE_KEYS_LX, sw_cuda.BAND_SHARED_LX
            res = []
            for wide_keys, rows_lx in ((0, saved[1]), (saved[0], 0), (0, 0)):
                sw_cuda.BAND_WIDE_KEYS_LX = wide_keys
                sw_cuda.BAND_SHARED_LX = rows_lx
                try:
                    other = sw_cuda.band_bounds(xt, ht, irt, iat, index)
                    after("band_build", name,
                          f"{'64' if wide_keys == 0 else '32'}-bit keys "
                          f"{'global' if rows_lx == 0 else 'shared'}")
                finally:
                    sw_cuda.BAND_WIDE_KEYS_LX, sw_cuda.BAND_SHARED_LX = saved
                nw = sum(int((w != g).sum().item())
                         for w, g in zip(other, got))
                res.append(f"{'64' if wide_keys == 0 else '32'}-bit keys, "
                           f"{'global' if rows_lx == 0 else 'shared'} rows "
                           f"{nw}")
                bad += nw
            log(f"band_build {name:11s} "
                f"{sw_cuda.band_route(x.shape[1])} route, 32-bit keys, "
                "against: " + "; ".join(res))
        band_worst = max(band_worst, *(
            int(np.abs(g.cpu().numpy().astype(np.int64) - h).max(initial=0))
            for g, h in zip(got, host)))
        matches = match_counts(xt, ht, irt, iat)
        jlo, jhi = host
        width = jhi.astype(np.int64) - jlo
        empty = int((width.sum(axis=0) == 0).sum())
        log(f"band_build {name:11s} R={len(x)} lx={x.shape[1]} "
            f"ly={haps.shape[1]}: bound mismatches vs host and plain {bad}; "
            f"matches per problem max {int(matches.max())}, total "
            f"{int(matches.sum())}; in-band cells {int(width.sum())}, max "
            f"jhi {int(jhi.max())}, problems with an empty band "
            f"{empty}/{width.shape[1]}")
        if bad:
            fail(f"band_build disagrees with the host reference or the "
                 f"plain version on {name}")
        args = (xt, ht, irt, iat) + tuple(got)
        err, ref = check_banded(name, args)
        worst = max(worst, err)
        if name == "unseeded" and (empty != width.shape[1] or ref.any().item()):
            fail("unseeded pairs have a band or a score")
        if name == "wide_40000" and (jhi.max() <= 32767
                                     or ref.min().item() < 100):
            fail("the wide family's band or score is not the expected one")
        if name == "repetitive" and int(matches.max()) < 1000:
            fail("the repetitive family has fewer matches than intended")
        if name == "parted":
            apart = int((np.maximum(jlo[:, 1::2] - jhi[:, 0::2],
                                    jlo[:, 0::2] - jhi[:, 1::2]) > 0)
                        .any(axis=0).sum())
            log(f"band_build parted: {apart} of {len(x)} reads have rows "
                "whose ref and alt bands do not meet")
            if apart < len(x) // 8:
                fail("the parted family's ref and alt bands meet")
        bad, err = check_rows(name, x, haps, ir, [h[:, 0::2] for h in host])
        rows_band = max(rows_band, bad)
        rows_worst = max(rows_worst, err)
    # one homopolymer locus: its chain pass runs over several ranges of the
    # scratch budget. The plain builder's loop over match ranks would take
    # minutes here, so the bounds are held against the host reference
    # only; sw_banded against its plain version as above.
    x, haps, ir, ia = homopolymer_locus(rng, HOMOPOLYMER_READS)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    matches = match_counts(xt, ht, irt, iat)
    saved = sw_cuda.BAND_SCRATCH_BYTES
    sw_cuda.BAND_SCRATCH_BYTES = HOMOPOLYMER_BUDGET or saved
    try:
        ranges = sw_cuda.band_ranges(
            torch.cumsum(matches, 0).cpu().numpy(), x.shape[1],
            sw_cuda.BAND_SCRATCH_BYTES, sw_cuda.band_route(x.shape[1]))
        t0 = time.perf_counter()
        got = sw_cuda.band_bounds(xt, ht, irt, iat)
        after("band_index, band_build", "homopolymer")
        dt = time.perf_counter() - t0
        budget = sw_cuda.BAND_SCRATCH_BYTES
    finally:
        sw_cuda.BAND_SCRATCH_BYTES = saved
    host = sw_native.band_bounds(x, haps, ir, ia, threads)
    bad = sum(int((g.cpu().numpy() != h).sum()) for g, h in zip(got, host))
    log(f"band_build homopolymer R={len(x)} lx={x.shape[1]} "
        f"ly={haps.shape[1]}: bound mismatches vs host {bad}; matches "
        f"{int(matches.sum())} ({int(matches.max())} per problem at most, "
        f"{12 * int(matches.sum()) / 2**30:.2f} GiB of match scratch), "
        f"{len(ranges)} chain-pass ranges of at most "
        f"{budget / 2**30:.2f} GiB; {dt:.3f} s")
    if bad:
        fail("band_build disagrees with the host reference on the "
             "homopolymer locus")
    if len(ranges) < 2:
        fail("the homopolymer locus fits one chain-pass range")
    err, _ = check_banded("homopolymer", (xt, ht, irt, iat) + tuple(got))
    worst = max(worst, err)
    worst = max(worst, check_wide_banded(rng, threads))
    worst = max(worst, check_banded_limit(rng, threads))
    err, bad = check_long_hap(rng, threads)
    index_worst = max(index_worst, index_families(rng))
    return (max(band_worst, bad), max(worst, err), index_worst, rows_band,
            rows_worst)


def check_rows(name, x, haps, ir, host):
    """Both banded kernels' plain-row mode on a family's (read, ref)
    problems: reads x against the rows haps[ir], identity indices. The
    bounds against the plain version and the host reference (`host`: its
    bounds of the same problems), the scores against the plain version,
    and banded_batch_scores (index, bounds and scores in one call) against
    them. Returns (bound mismatches, max |err|)."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import band_torch, sw_banded_torch, sw_cuda

    xt = torch.from_numpy(x).cuda()
    yt = torch.from_numpy(np.ascontiguousarray(haps[ir])).cuda()
    ident = torch.arange(len(x), dtype=torch.int32, device="cuda")
    n0 = (launch_count("band_build.rows"), launch_count("sw_banded.rows"))
    got = sw_cuda.band_bounds(xt, yt, ident)
    after("band_index, band_build", name, "plain rows")
    plain = band_torch.band_bounds(xt, yt, ident)
    sync()
    bad = sum(int((g.cpu().numpy() != h).sum()) + int((g != q).sum().item())
              for g, h, q in zip(got, host, plain))
    whole = sw_cuda.banded_batch_scores(xt, yt)
    after("band_index, band_build, sw_banded", name,
          "plain rows, banded_batch_scores")
    ref = sw_banded_torch.banded_scores(xt, yt, *got)
    sync()
    errs = {}
    for route in banded_routes(x.shape[1], haps.shape[1]):
        sc = sw_cuda.banded_scores(xt, yt, *got, route=route)
        after("sw_banded", name, f"plain rows {route}")
        errs[route] = int((sc - ref).abs().max().item()) if len(x) else 0
    err = max(*errs.values(), int((whole - ref).abs().max().item())
              if len(x) else 0)
    n = (launch_count("band_build.rows") - n0[0],
         launch_count("sw_banded.rows") - n0[1])
    log(f"plain rows {name:11s} B={len(x)} lx={x.shape[1]} ly={haps.shape[1]}"
        f": band_build bound mismatches vs host and plain {bad}; sw_banded "
        f"max|err| " + ", ".join(f"{r} {e}" for r, e in errs.items())
        + f", in banded_batch_scores {err}; launches in plain-row mode {n}")
    if bad or err or min(n) < 2:
        fail(f"the plain-row banded mode disagrees on {name}")
    return bad, err


def check_wide_banded(rng, threads):
    """band_build past 2^31 cells per problem and sw_banded's 64-bit
    scratch word on wide_full_family: the bounds against the host
    reference (the plain builder's all-pairs mask would hold 4.6 G cells
    per problem), the banded scores against the plain version and the
    known scores."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda, sw_native

    x, haps, ir, ia, known = wide_full_family(rng)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    t0 = time.perf_counter()
    got = sw_cuda.band_bounds(xt, ht, irt, iat)
    after("band_index, band_build", "wide")
    dt = time.perf_counter() - t0
    host = sw_native.band_bounds(x, haps, ir, ia, threads)
    bad = sum(int((g.cpu().numpy() != h).sum()) for g, h in zip(got, host))
    log(f"band_build wide R={len(x)} lx={x.shape[1]} ly={haps.shape[1]} "
        f"({x.shape[1] * haps.shape[1]} cells per problem): bound "
        f"mismatches vs host {bad}; {dt:.3f} s")
    if bad:
        fail("band_build disagrees with the host reference on the wide "
             "family")
    n0 = launch_count("sw_banded.pair")
    err, ref = check_banded("wide", (xt, ht, irt, iat) + tuple(got))
    if (ref.T.cpu() != torch.tensor(known)).any() or \
            launch_count("sw_banded.pair") - n0 != 2:
        fail("sw_banded's 64-bit scratch word: not the known scores")
    return err


def check_long_hap(rng, threads):
    """long_hap_family under 16 MiB scratch budgets: band_index once,
    band_build (several chain-pass ranges) against the plain version and
    the host reference, sw_banded (scores and codes) and sw_pair (scores)
    over several read ranges against their plain versions. Returns (max
    |err| of the DP kernels, bound mismatches)."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import band_torch, sw_cuda, sw_native, sw_torch

    x, haps, ir, ia = long_hap_family(rng, LONG_HAP_READS)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    saved = sw_cuda.DP_SCRATCH_BYTES, sw_cuda.BAND_SCRATCH_BYTES
    sw_cuda.DP_SCRATCH_BYTES = sw_cuda.BAND_SCRATCH_BYTES = 16 << 20
    try:
        n0 = (launch_count(*SW_PAIR), launch_count("sw_banded.pair"),
              launch_count("band_build.pair"))
        t0 = time.perf_counter()
        index, _ = check_index("long_hap", ht)
        got = sw_cuda.band_bounds(xt, ht, irt, iat, index)
        after("band_build", "long_hap", sw_cuda.band_route(x.shape[1]))
        dt = time.perf_counter() - t0
        n_band = launch_count("band_build.pair") - n0[2]
        args = (xt, ht, irt, iat) + tuple(got)
        err, _ = check_banded("long_hap", args)
        n_banded = (launch_count("sw_banded.pair") - n0[1]) // (
            2 * len(banded_routes(x.shape[1], haps.shape[1])))
        pair = sw_cuda.pair_scores(xt, ht, irt, iat)
        after("sw_pair", "long_hap",
              sw_cuda.pair_route(x.shape[1], haps.shape[1]))
        n_pair = launch_count(*SW_PAIR) - n0[0]
    finally:
        sw_cuda.DP_SCRATCH_BYTES, sw_cuda.BAND_SCRATCH_BYTES = saved
    t1 = time.perf_counter()
    plain = band_torch.band_bounds(xt, ht, irt, iat)
    sync()
    t2 = time.perf_counter()
    plain_pair = sw_torch.pair_scores(xt, ht, irt, iat)
    sync()
    plain_dt = (t2 - t1, time.perf_counter() - t2)
    host = sw_native.band_bounds(x, haps, ir, ia, threads)
    bad = sum(int((g.cpu().numpy() != h).sum()) + int((g != q).sum().item())
              for g, h, q in zip(got, host, plain))
    pair_err = int((pair - plain_pair).abs().max().item())
    matches = match_counts(xt, ht, irt, iat)
    log(f"band_build long_hap R={len(x)} lx={x.shape[1]} ly={haps.shape[1]}"
        f": bound mismatches vs host and plain {bad}; matches per problem "
        f"max {int(matches.max())}, total {int(matches.sum())}; "
        f"{n_band} chain-pass ranges, {dt:.3f} s with the index; plain "
        f"builder {plain_dt[0]:.1f} s, plain sw_pair {plain_dt[1]:.1f} s")
    log(f"sw_pair long_hap dense R={len(x)}: max|err|={pair_err}, max score "
        f"{int(plain_pair.max().item())}; {n_pair} read ranges; sw_banded "
        f"{n_banded} read ranges per call")
    if bad:
        fail("band_build disagrees with the host reference or the plain "
             "version on the long haplotype")
    if pair_err:
        fail("sw_pair disagrees with the plain version on the long "
             "haplotype")
    if min(n_band, n_banded, n_pair) < 2:
        fail("a kernel ran the long haplotype in one range")
    if plain_pair.max(dim=0).values.min().item() <= 100:
        fail("a read of the long haplotype family does not score")
    return max(err, pair_err), bad


def banded_routes(lx, ly):
    """sw_banded's routes that hold an lx x ly bucket (packed: ly <=
    32,767; word32: min(lx, ly) <= 65,535; word64: any): the one
    banded_route picks first, then the others."""
    from vartrix_tpu_torch.ops import sw_cuda

    holds = (ly <= sw_cuda.PACKED_MAX, min(lx, ly) < 1 << 16, True)
    own = sw_cuda.banded_route(lx, ly)
    return [own] + [r for r, ok in zip(sw_cuda.PAIR_ROUTES, holds)
                    if ok and r != own]


def check_banded(name, args):
    """sw_banded's scores and codes on `args` (reads, haplotypes, indices,
    bounds on the card) on every route that holds the width against its
    plain version; (max |err|, the plain scores)."""
    from vartrix_tpu_torch.ops import sw_banded_torch, sw_cuda, sw_torch

    t0 = time.perf_counter()
    ref = sw_banded_torch.banded_pair_scores(*args)
    sync()
    dt = time.perf_counter() - t0
    calls = sw_torch.calls_from_scores(ref)
    res = {}
    for route in banded_routes(args[0].shape[1], args[1].shape[1]):
        sc = sw_cuda.banded_pair_scores(*args, route=route)
        after("sw_banded", name, f"{route} scores")
        codes = sw_cuda.banded_pair_calls(*args, route=route)
        after("sw_banded", name, f"{route} codes")
        res[route] = (int((sc - ref).abs().max().item()),
                      int((codes != calls).sum().item()))
    log(f"sw_banded {name:11s}: " + "; ".join(
        f"{route} max|err|={e} code mismatches={b}"
        for route, (e, b) in res.items())
        + f"; max score {int(ref.max().item())}; plain {dt:.1f} s")
    if any(e or b for e, b in res.values()):
        fail(f"sw_banded disagrees with the plain version on {name}")
    return 0, ref


def check_banded_limit(rng, threads):
    """sw_banded at its packed route's edge, ly = 32,767
    (packed_limit_family: lx = 32,768, ly = 32,767; the first read scores
    32,767, the greatest H and column offset the route holds):
    band_build's bounds against the host reference (the plain
    builder's all-pairs mask would hold 1 G cells per problem), the scores
    on every route in both per_read modes against the plain version.
    Returns max |err|."""
    from vartrix_tpu_torch.ops import sw_cuda, sw_native

    x, haps, ir, ia, _ = packed_limit_family(rng)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    got = sw_cuda.band_bounds(xt, ht, irt, iat)
    after("band_index, band_build", "packed_limit")
    host = sw_native.band_bounds(x, haps, ir, ia, threads)
    bad = sum(int((g.cpu().numpy() != h).sum()) for g, h in zip(got, host))
    log(f"band_build packed_limit R={len(x)} lx={x.shape[1]} "
        f"ly={haps.shape[1]}: bound mismatches vs host {bad}")
    if bad:
        fail("band_build disagrees with the host reference on the packed "
             "limit family")
    _, ref = check_banded("packed_limit", (xt, ht, irt, iat) + tuple(got))
    if sw_cuda.banded_route(x.shape[1], haps.shape[1]) != "packed" or \
            ref.max().item() != haps.shape[1]:
        fail("the packed limit family is not at the packed route's edge")
    y = ht[irt.long()]
    lo, hi = (b[:, 0::2].contiguous() for b in got)
    errs = {}
    for route in banded_routes(x.shape[1], haps.shape[1]):
        sc = sw_cuda.banded_scores(xt, y, lo, hi, route=route)
        after("sw_banded", "packed_limit", f"plain rows {route}")
        errs[route] = int((sc - ref[0]).abs().max().item())
    log("plain rows packed_limit: sw_banded max|err| " + ", ".join(
        f"{r} {e}" for r, e in errs.items()))
    if any(errs.values()):
        fail("sw_banded's plain-row mode disagrees at the packed limit")
    return 0


def time_cuda(fn, warmup, reps):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def pair_cells(x, haps, idx_ref, idx_alt, strip, cols=1):
    """Cells sw_pair's packed route computes: per read, both problems over
    its length rounded up to `strip` rows and the longer haplotype rounded
    up to `cols` columns."""
    import numpy as np

    lx_true = (x != 0).sum(1).astype(np.int64)
    lx_true = (lx_true + strip - 1) // strip * strip
    h_true = (haps != 1).sum(1).astype(np.int64)
    h = np.maximum(h_true[idx_ref], h_true[idx_alt])
    h = (h + cols - 1) // cols * cols
    return int((2 * lx_true * h * (h_true[idx_ref] + h_true[idx_alt] > 0)
                ).sum())


def dpx_rate(path, clock_hz):
    """The card's 16x2 DPX add-max rate, warp instructions per SM and
    clock, from DPX_RATE_SRC over eight blocks of 256 threads per SM."""
    import ctypes

    import torch

    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dpx_rate_launch.restype = ci
    lib.dpx_rate_launch.argtypes = [vp, ci, ci, vp, vp]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 4096
    src = torch.full((16,), 0x01010101, dtype=torch.int32, device="cuda")
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")

    def run():
        err = lib.dpx_rate_launch(src.data_ptr(), iters, blocks,
                                  out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the DPX rate probe did not launch ({err})")

    ms = time_cuda(run, 2, 5)
    rate = blocks * 256 / 32 * iters * 32 / (ms / 1e3) / sms / clock_hz
    log(f"timing DPX add-max (VIADDMNMX.S16x2) rate: {rate:.3f} warp "
        f"instructions per SM per clock ({ms:.4f} ms for {blocks} blocks x "
        f"256 threads x {iters * 32} add-maxes; issue is "
        f"{ISSUE_PER_SM_CLK // 32} per SM per clock)")
    return rate


def phase_timing(rng, sass, clock_hz, rate_path):
    """sw_pair at the main bucket shape: its packed route (the path's) and
    its 32-bit scalar route in turns, the plain version, and the bound:
    the needed cells x the least cell update's instructions (the cell
    probe's SASS) over the card's instruction issue rate (every
    instruction issues once, whatever pipe runs it), against the bytes
    over HBM bandwidth. For information: the same cells at the probe's
    DPX instructions over the card's DPX add-max rate, the kernel's own
    SASS per cell, its registers and the extra cells its pairs compute.
    Then the packed route's three read formats in turns (2-bit, 4-bit,
    dense) with the 4-bit entry's bound, and the haplotypes' unpack."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import _build, sw_cuda, sw_torch

    x, haps, ir, ia = make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224))
    xp, lens = pack2(x)
    xp4, _ = pack4(x)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    xpt = torch.from_numpy(xp).cuda()
    xp4t = torch.from_numpy(xp4).cuda()
    lt = torch.from_numpy(lens).cuda()
    times = collections.defaultdict(list)
    for route in ("word32", "packed", "packed", "word32"):
        times[route].append(time_cuda(lambda: sw_cuda.pair_calls(
            xpt, ht, irt, iat, read_lens=lt, route=route), 3, 15))
    ms, scalar_ms = (statistics.median(times[r]) for r in ("packed",
                                                           "word32"))
    # the packed route's three read formats on the same bytes, in turns
    formats = {"p2": (xpt, lt, 2), "p4": (xp4t, lt, 4),
               "dense": (xt, None, 2)}
    for form in ("p2", "p4", "dense", "dense", "p4", "p2"):
        reads, rl, bits = formats[form]
        times[form].append(time_cuda(lambda: sw_cuda.pair_calls(
            reads, ht, irt, iat, read_lens=rl, read_bits=bits), 3, 15))
    form_ms = {f: statistics.median(times[f]) for f in formats}
    # a bucket's haplotypes, shipped 4-bit, unpacked once on the card
    hp, hlen = pack4(np.where(haps == 1, 0, haps).astype(np.uint8))
    hpt, hlt = torch.from_numpy(hp).cuda(), torch.from_numpy(hlen).cuda()
    if not torch.equal(sw_torch.unpack4(hpt, hlt, MAIN_LY, pad=1), ht):
        fail("the haplotypes' 4-bit unpack differs from the dense matrix")
    unpack_ms = time_cuda(lambda: sw_torch.unpack4(hpt, hlt, MAIN_LY, pad=1),
                          3, 15)
    plain_ms = time_cuda(lambda: sw_torch.pair_calls(xpt, ht, irt, iat,
                                                     read_lens=lt), 1, 3)
    cells = true_cells(x, haps, ir, ia)
    strip = sw_cuda.PACKED_STRIP
    computed = pair_cells(x, haps, ir, ia, strip, sw_cuda.PACKED_COLS)
    own = true_cells(x, haps, ir, ia, strip=strip)
    scalar_computed = true_cells(x, haps, ir, ia, strip=sw_cuda.PAIR_STRIP)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_per_s = sms * ISSUE_PER_SM_CLK * clock_hz
    ops_ms = cells * sass["cell"] / issue_per_s * 1e3
    rate = dpx_rate(rate_path, clock_hz)
    dpx_ms = cells * sass["cell_dpx"] / (sms * 32 * rate * clock_hz) * 1e3
    nbytes = (xp.nbytes + lens.nbytes + haps.nbytes + ir.nbytes + ia.nbytes
              + MAIN_READS)  # inputs read once, int8 codes written once
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    # the 4-bit entry: the same cells, each read base unpacked once per
    # problem pair (its strip loads it once), its own bytes
    read_bases = int(lens.astype(np.int64).sum())
    p4_ops_ms = ((cells * sass["cell"] + read_bases * sass["nibble"])
                 / issue_per_s * 1e3)
    p4_bytes = nbytes - xp.nbytes + xp4.nbytes
    p4_bytes_ms = p4_bytes / HBM_BYTES_PER_S * 1e3
    p4_bound_ms = max(p4_ops_ms, p4_bytes_ms)
    regs = {sym: registers(_build.kernel_library(), sym)
            for sym in (MAIN_KERNEL_SYMBOL, SCALAR_KERNEL_SYMBOL)}
    log(f"timing sw_pair at lx={MAIN_LX} ly={MAIN_LY}, {2 * MAIN_READS} pairs "
        f"(2-bit reads, int8 codes): packed route {ms:.4f} ms "
        f"({cells / ms / 1e6:.1f} G needed cells/s; "
        + ", ".join(f"{t:.4f}" for t in times["packed"])
        + f"), 32-bit scalar route {scalar_ms:.4f} ms ("
        + ", ".join(f"{t:.4f}" for t in times["word32"])
        + f"), in turns; plain {plain_ms:.3f} ms")
    log(f"timing sw_pair cells: {cells} needed; the packed route computes "
        f"{computed} ({strip}-row strips, pairs to their longer haplotype "
        f"rounded up to {sw_cuda.PACKED_COLS} columns: {computed - own} "
        f"extra cells beyond each problem's own strips), the scalar route "
        f"{scalar_computed} ({sw_cuda.PAIR_STRIP}-row strips); SASS per "
        f"problem cell: packed loop {sass['packed']:.4f} "
        f"({sass['packed_dpx']:.4f} DPX), scalar loop {sass['scalar']:.4f}, "
        f"least update (probe) {sass['cell']:.4f} ({sass['cell_dpx']:.4f} "
        f"DPX); registers: packed {regs[MAIN_KERNEL_SYMBOL]}, scalar "
        f"{regs[SCALAR_KERNEL_SYMBOL]}")
    log(f"timing bound: {cells} needed cells x {sass['cell']:.4f} "
        f"instructions per cell (the cell probe's SASS) / ({sms} SMs x "
        f"{ISSUE_PER_SM_CLK} per clock x {clock_hz / 1e9:.3f} GHz = "
        f"{issue_per_s:.6g} instructions/s) = {ops_ms:.4f} ms; {nbytes} "
        f"bytes / {HBM_BYTES_PER_S:.3g} B/s = {bytes_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms: {100 * bound_ms / ms:.1f} % of the packed "
        f"route's time, {100 * bound_ms / scalar_ms:.1f} % of the scalar "
        f"route's; at the card's DPX add-max rate the probe's "
        f"{sass['cell_dpx']:.4f} DPX per cell take {dpx_ms:.4f} ms "
        f"({100 * dpx_ms / ms:.1f} % of the packed route's time); "
        "library_ms null: no PyTorch call computes Smith-Waterman")
    log("timing sw_pair read formats on the packed route, the same reads, "
        "in turns (p2, p4, dense, dense, p4, p2): "
        + "; ".join(f"{f} {form_ms[f]:.4f} ms ("
                    + ", ".join(f"{t:.4f}" for t in times[f]) + ")"
                    for f in formats)
        + f"; 4-bit on 2-bit "
        f"{100 * (form_ms['p4'] / form_ms['p2'] - 1):+.2f} %")
    log(f"timing sw_pair 4-bit bound: {cells} cells x {sass['cell']:.4f} + "
        f"{read_bases} read bases x {sass['nibble']:.1f} (the least nibble "
        f"unpack, the nibble probe's SASS) instructions = {p4_ops_ms:.4f} "
        f"ms; {p4_bytes} bytes "
        f"= {p4_bytes_ms:.4f} ms; bound {p4_bound_ms:.4f} ms, "
        f"{100 * p4_bound_ms / form_ms['p4']:.1f} % of its time")
    log(f"timing haplotype unpack (sw_torch.unpack4, pad 1, once per "
        f"bucket): {haps.shape[0]} rows x {MAIN_LY}: {unpack_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None, scalar_ms=scalar_ms,
                packed4_ms=form_ms["p4"], dense_ms=form_ms["dense"],
                packed2_ms=form_ms["p2"], packed4_bound_ms=p4_bound_ms,
                hap_unpack_ms=unpack_ms)


def phase_banded_timing(rng, sass, clock_hz, threads, probes):
    """band_build and sw_banded at the main bucket shape: kernel and plain
    times, bounds, and what the zones cost.

    band_build's bound: its bytes (reads, haplotypes and indices read
    once, bounds written once) against its operations, len_x - 5 key
    lookups per problem at KEY_LOOKUP_INSTR each plus min(64, rank) chain
    candidates per match of these inputs at the instructions of scoring
    one (the probe's SASS), at the issue rate.
    sw_banded's bound: the in-band cells x the least cell update (the cell
    probe's SASS; a scan that starts and stops each row at its band edges
    tests nothing per cell), against its bytes (reads, haplotypes,
    indices, bounds in, codes out). Also the host reference's time per
    pair, the route band_build replaced.

    The plain-row mode (the Python host path's) on the same 131,072
    problems as plain rows in that path's order (core/pipeline.score_all:
    each read against its ref row, then its alt row), identity indices,
    timed in turns with the pair mode (pair, rows, rows, pair): the same
    bounds, counted the same way, with the rows' bytes (a read, a
    haplotype row and an index per problem; int32 scores out).

    band_build's time split (band_split): the count pass, the device sum
    and the host read of the total, and the chain pass, which the chain DP
    probe (the kernel stopped where its DP ends) cuts into the DP and the
    traceback with the band fill, and the lookups probe (also without its
    DP steps) cuts the DP into its lookups and its DP steps; and the chain
    DP under other problem-to-lane mappings (mapping_split). probes: the
    paths of the chain DP, lookups, mapping and empty kernel probes.

    Where band_build's DP step issues fewer instructions per candidate,
    with its upkeep, than the bound charges a candidate, the bound is no
    lower bound of this kernel, and no share of it is reported."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import (_build, band_torch, sw_banded_torch,
                                       sw_cuda, sw_native)

    per_candidate, pair_instr = sass["per_candidate"], sass["cell"]
    x, haps, ir, ia = make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224))
    pairs = 2 * MAIN_READS
    sw_native.band_bounds(x[:64], haps, ir[:64], ia[:64], threads)  # load
    n1 = 4096
    t0 = time.perf_counter()
    sw_native.band_bounds(x[:n1], haps, ir[:n1], ia[:n1], 1)
    one_us = (time.perf_counter() - t0) / (2 * n1) * 1e6
    t0 = time.perf_counter()
    sw_native.band_bounds(x, haps, ir, ia, threads)
    host_us = (time.perf_counter() - t0) / pairs * 1e6
    args = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    index = sw_cuda.band_index(args[1])
    xr = args[0].repeat_interleave(2, dim=0)
    yr = args[1][torch.stack([args[2], args[3]], 1).reshape(-1).long()]
    ident = torch.arange(pairs, dtype=torch.int32, device="cuda")
    index_r = sw_cuda.band_index(yr)
    band_fn = {"pair": lambda: sw_cuda.band_bounds(*args, index),
               "rows": lambda: sw_cuda.band_bounds(xr, yr, ident,
                                                   index=index_r)}
    band_times = collections.defaultdict(list)
    for mode in ("pair", "rows", "rows", "pair"):
        band_times[mode].append(time_cuda(band_fn[mode], 3, 15))
    band_ms, band_rows_ms = (statistics.median(band_times[m])
                             for m in ("pair", "rows"))
    band_plain_ms = time_cuda(lambda: band_torch.band_bounds(*args), 1, 2)
    band_rows_plain_ms = time_cuda(lambda: band_torch.band_bounds(xr, yr,
                                                                  ident), 1, 2)
    jlo_t, jhi_t = sw_cuda.band_bounds(*args, index)
    jlo_r, jhi_r = sw_cuda.band_bounds(xr, yr, ident, index=index_r)
    jlo, jhi = jlo_t.cpu().numpy(), jhi_t.cpu().numpy()
    if not (torch.equal(jlo_r, jlo_t) and torch.equal(jhi_r, jhi_t)):
        fail("band_build's plain-row bounds differ from its pair bounds")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_per_s = sms * ISSUE_PER_SM_CLK * clock_hz
    counts = match_counts(*args).cpu().numpy()
    cand = int(np.where(counts <= 65, counts * (counts - 1) // 2,
                        2080 + 64 * (counts - 65)).sum())
    len_x = np.repeat((x != 0).sum(1), 2)
    lookups = int(np.maximum(len_x - 5, 0).sum())
    b_ops = lookups * KEY_LOOKUP_INSTR + cand * per_candidate
    b_ops_ms = b_ops / issue_per_s * 1e3
    b_bytes = (x.nbytes + haps.nbytes + ir.nbytes + ia.nbytes + jlo.nbytes
               + jhi.nbytes)
    b_bytes_ms = b_bytes / HBM_BYTES_PER_S * 1e3
    b_bound = max(b_ops_ms, b_bytes_ms)
    step = sass["chain_step"] * 32 / 64  # the DP step's, per candidate
    bound_holds = step >= per_candidate
    log(f"timing band_build at lx={MAIN_LX} ly={MAIN_LY}, {pairs} pairs: "
        f"{band_ms:.4f} ms ({band_ms / pairs * 1e6:.4f} ns per pair; count, "
        f"device sum, one read of the total, chain; the index built "
        f"before); plain {band_plain_ms:.3f}"
        f" ms; host reference (the route it replaced) {host_us:.3f} us per "
        f"pair on {threads} threads, {one_us:.3f} us on one")
    log(f"timing band_build bound: ({lookups} key lookups x "
        f"{KEY_LOOKUP_INSTR} instructions (source count) + {cand} chain "
        f"candidates ({int(counts.sum())} matches, {counts.mean():.1f} per "
        f"problem) x {per_candidate} instructions (the probe's SASS)) / "
        f"{issue_per_s:.6g} instructions/s = {b_ops_ms:.4f} ms; {b_bytes} "
        f"bytes / {HBM_BYTES_PER_S:.3g} B/s = {b_bytes_ms:.4f} ms; bound "
        f"{b_bound:.4f} ms"
        + (f", {100 * b_bound / band_ms:.1f} % of the kernel's time"
           if bound_holds else
           f"; band_build's own DP step issues {step:.4f} per candidate, "
           f"upkeep included, below the {per_candidate} charged: at its "
           f"{step:.4f} the candidates take "
           f"{cand * step / issue_per_s * 1e3:.4f} ms, so the bound is no "
           "lower bound here and no share of it is reported")
        + "; library_ms null: no PyTorch call builds a chained band")
    dp_probe, lookups_probe, mapping_probe, _ = probes
    split = band_split(sw_cuda._band_kernel(),
                       {"dp": sw_cuda.bind_band_library(dp_probe),
                        "lookups": sw_cuda.bind_band_library(lookups_probe)},
                       args, index, sw_cuda.band_route(MAIN_LX),
                       (jlo_t, jhi_t))
    n_match = int(counts.sum())
    log_split("band_build", split, band_ms,
              n_match * sass["chain_step"] / (issue_per_s / 32) * 1e3)
    mapping = mapping_split(mapping_probe, sw_cuda._band_kernel(), args,
                            index)
    log("timing band_build chain DP by mapping (the mapping probe: lookups, "
        "gathering and DP steps, no traceback; best matches and "
        "predecessor distances equal to band_build's): " + ", ".join(
            f"{lanes} lanes per problem {ms:.4f} ms ({per:.4f} SASS per "
            f"candidate)" for lanes, (ms, per) in mapping.items())
        + f"; band_build's own chain DP probe {split['dp']:.4f} ms")
    band = dict(ms=band_ms, plain_ms=band_plain_ms, bound_ms=b_bound,
                bound_by="operations" if b_ops_ms >= b_bytes_ms else "bytes",
                library_ms=None, split=split,
                mapping_ms={lanes: ms for lanes, (ms, _) in mapping.items()},
                share_of_bound=b_bound / band_ms if bound_holds else None,
                share_note="its DP step issues fewer instructions per "
                "candidate than the bound charges: the bound is no lower "
                "bound")
    # the plain rows carry a haplotype row and an index per problem
    rows_in = xr.numel() + yr.numel() + 4 * pairs
    rb_bytes_ms = (rows_in + jlo.nbytes + jhi.nbytes) / HBM_BYTES_PER_S * 1e3
    rb_bound = max(b_ops_ms, rb_bytes_ms)
    log(f"timing band_build plain rows: {pairs} problems in "
        f"{band_rows_ms:.4f} ms ("
        + ", ".join(f"{t:.4f}" for t in band_times["rows"])
        + ") against the pair mode's " + ", ".join(
            f"{t:.4f}" for t in band_times["pair"])
        + f" ms in turns ({100 * (band_rows_ms / band_ms - 1):+.1f} %); "
        f"plain {band_rows_plain_ms:.3f} ms; bound {rb_bound:.4f} ms "
        f"(operations {b_ops_ms:.4f} ms as the pair mode's, "
        f"{rows_in + jlo.nbytes + jhi.nbytes} bytes {rb_bytes_ms:.4f} ms)"
        + (f", {100 * rb_bound / band_rows_ms:.1f} % of the kernel's time"
           if bound_holds else ", no share reported (as the pair mode)"))
    band_rows = dict(ms=band_rows_ms, plain_ms=band_rows_plain_ms,
                     bound_ms=rb_bound, library_ms=None,
                     bound_by="operations" if b_ops_ms >= rb_bytes_ms
                     else "bytes",
                     share_of_bound=(rb_bound / band_rows_ms if bound_holds
                                     else None),
                     share_note=band["share_note"])
    index_timing = time_index(args[1], issue_per_s, probes[3], rng)
    # sw_banded on the kernel's bounds: its packed route (the path's) and
    # its 32-bit scalar route, in turns, in both modes; plain rows also in
    # an order that pairs unrelated problems in a packed thread
    perm = torch.from_numpy(rng.permutation(pairs)).cuda()
    shuffled = (xr[perm], yr[perm], jlo_r[:, perm].contiguous(),
                jhi_r[:, perm].contiguous())
    dp_args = args + (jlo_t, jhi_t)
    dp_fn = {"pair": lambda route: sw_cuda.banded_pair_calls(*dp_args,
                                                             route=route),
             "rows": lambda route: sw_cuda.banded_scores(
                 xr, yr, jlo_r, jhi_r, route=route),
             "unrelated rows": lambda route: sw_cuda.banded_scores(
                 *shuffled, route=route)}
    order = [("pair", "word32"), ("pair", "packed"), ("rows", "packed"),
             ("rows", "word32"), ("unrelated rows", "packed")]
    dp_times = collections.defaultdict(list)
    for mode, route in order + order[::-1]:
        dp_times[mode, route].append(time_cuda(
            lambda: dp_fn[mode](route), 3, 15))
    med = {k: statistics.median(v) for k, v in dp_times.items()}
    ms, rows_ms = med["pair", "packed"], med["rows", "packed"]
    plain_ms = time_cuda(lambda: sw_banded_torch.banded_pair_calls(
        *dp_args), 1, 3)
    rows_plain_ms = time_cuda(lambda: sw_banded_torch.banded_scores(
        xr, yr, jlo_r, jhi_r), 1, 3)
    for route in ("packed", "word32"):
        pair_got = sw_cuda.banded_pair_scores(*dp_args, route=route)
        rows_got = sw_cuda.banded_scores(xr, yr, jlo_r, jhi_r, route=route)
        unrelated = torch.empty_like(rows_got)
        unrelated[perm] = sw_cuda.banded_scores(*shuffled, route=route)
        if not (torch.equal(rows_got, pair_got.T.reshape(-1))
                and torch.equal(unrelated, rows_got)):
            fail(f"sw_banded's plain-row scores differ from its pair scores "
                 f"on the {route} route")
    in_band = int((jhi.astype(np.int64) - jlo).sum())
    full = true_cells(x, haps, ir, ia)
    ops_ms = in_band * pair_instr / issue_per_s * 1e3
    nbytes = (x.nbytes + haps.nbytes + ir.nbytes + ia.nbytes + jlo.nbytes
              + jhi.nbytes + MAIN_READS)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    # the bound charges a cell the least update; it bounds the kernel
    # while the packed core loop issues no fewer per problem cell
    dp_bound_holds = sass["zones"]["packed"][0] >= pair_instr
    log(f"timing sw_banded cells: {in_band} in band ({in_band / pairs:.1f} "
        f"per pair; full SW needs {full}, {100 * in_band / full:.1f} %)")
    log(f"timing sw_banded bound: {in_band} in-band cells x "
        f"{pair_instr:.4f} instructions per cell (the least cell update, "
        f"the cell probe's SASS) / {issue_per_s:.6g} instructions/s = "
        f"{ops_ms:.4f} ms; {nbytes} bytes / {HBM_BYTES_PER_S:.3g} B/s = "
        f"{bytes_ms:.4f} ms; bound {bound_ms:.4f} ms; the packed core loop "
        f"issues {sass['zones']['packed'][0]:.4f} per problem cell, "
        + ("no fewer than charged" if dp_bound_holds else
           "fewer than charged: no lower bound, no share reported")
        + "; library_ms null: no PyTorch call computes Smith-Waterman")
    lens = np.repeat((x != 0).sum(1), 2)
    order_lens, order_lo, order_hi = (lens[perm.cpu().numpy()],
                                      *(b[:, perm.cpu().numpy()]
                                        for b in (jlo, jhi)))
    for route, sym in (("packed", BANDED_KERNEL_SYMBOL),
                       ("word32", BANDED_SCALAR_SYMBOL)):
        packed = route == "packed"
        visited, core, idle = strip_stats(lens, jlo, jhi, MAIN_LY, packed)
        core_i, masked_i = sass["zones"][route]
        issued = core * core_i + (visited - core) * masked_i
        issued_ms = issued / issue_per_s * 1e3
        regs = registers(_build.banded_kernel_library(), sym)
        per_sm = min(SM_THREADS // 128, SM_REGISTERS // (128 * (
            -(-regs // REGISTER_UNIT) * REGISTER_UNIT)))
        blocks = -(-pairs // (256 if packed else 128))
        t = {m: med[m, route] for m in ("pair", "rows")}
        log(f"timing sw_banded {route} route: {t['pair']:.4f} ms pair mode "
            f"({in_band / t['pair'] / 1e6:.1f} G in-band cells/s), "
            f"{t['rows']:.4f} plain rows; visits {visited} problem cells "
            f"({100 * visited / in_band:.1f} % of in band), {core} in the "
            f"core ({100 * core / visited:.1f} % of visited) at "
            f"{core_i:.4f} instructions per problem cell and "
            f"{visited - core} masked at {masked_i:.4f}; "
            f"{issued / in_band:.4f} issued per in-band cell, "
            f"{issued_ms:.4f} ms at full issue "
            f"({100 * issued_ms / t['pair']:.1f} % of the pair mode's "
            f"time); its warps leave {100 * idle:.1f} % of lane slots idle; "
            f"{regs} registers, {per_sm} blocks of 128 per SM, {blocks} "
            f"blocks: {blocks / (sms * per_sm):.2f} waves")
        if packed:
            u_visited, u_core, u_idle = strip_stats(order_lens, order_lo,
                                                    order_hi, MAIN_LY, True)
            log(f"timing sw_banded packed route, plain rows of unrelated "
                f"pairs: {med['unrelated rows', route]:.4f} ms; visits "
                f"{u_visited} problem cells "
                f"({100 * u_visited / in_band:.1f} % of in band), "
                f"{100 * u_core / u_visited:.1f} % in the core; "
                f"{100 * u_idle:.1f} % of lane slots idle")
    log(f"timing sw_banded: {ms:.4f} ms packed, {med['pair', 'word32']:.4f}"
        f" ms word32, in turns (" + "; ".join(
            f"{m} {r} " + ", ".join(f"{v:.4f}" for v in dp_times[m, r])
            for m, r in order)
        + f"); plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms"
        + (f", {100 * bound_ms / ms:.1f} % of the packed route's time"
           if dp_bound_holds else ", no share reported"))
    share_note = ("its packed core loop issues fewer instructions per "
                  "problem cell than the bound charges: the bound is no "
                  "lower bound")
    banded = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                  library_ms=None, scalar_ms=med["pair", "word32"],
                  share_of_bound=bound_ms / ms if dp_bound_holds else None,
                  share_note=share_note)
    r_bytes = rows_in + jlo.nbytes + jhi.nbytes + 4 * pairs
    r_bytes_ms = r_bytes / HBM_BYTES_PER_S * 1e3
    r_bound = max(ops_ms, r_bytes_ms)
    log(f"timing sw_banded plain rows (int32 scores): {pairs} problems in "
        f"{rows_ms:.4f} ms on the packed route against the pair mode's "
        f"(int8 codes) {ms:.4f} ms in turns ({100 * (rows_ms / ms - 1):+.1f}"
        f" %; word32 {med['rows', 'word32']:.4f} against "
        f"{med['pair', 'word32']:.4f}); plain {rows_plain_ms:.3f} ms; bound "
        f"{r_bound:.4f} ms (operations {ops_ms:.4f} ms as the pair mode's, "
        f"{r_bytes} bytes {r_bytes_ms:.4f} ms)"
        + (f", {100 * r_bound / rows_ms:.1f} % of the kernel's time"
           if dp_bound_holds else ", no share reported"))
    banded_rows = dict(ms=rows_ms, plain_ms=rows_plain_ms, bound_ms=r_bound,
                       bound_by="operations" if ops_ms >= r_bytes_ms
                       else "bytes", library_ms=None,
                       scalar_ms=med["rows", "word32"],
                       share_of_bound=(r_bound / rows_ms if dp_bound_holds
                                       else None),
                       share_note=share_note)
    return band, banded, index_timing, band_rows, banded_rows

# the lines of csrc/band_build.cu's chain kernel after which its chain DP
# is done, and where each chunk's DP steps start: the chain DP probe, a
# copy of the source, returns at the first; the lookups probe at both
CHAIN_DP_END = "// -- the chain DP ends here --"
CHUNK_DP_START = "// -- a chunk's DP starts here --"
SPLIT_PARTS = ("count", "device sum", "host read", "chain")


def probe_source(src, lookups=False):
    """band_build.cu's source `src` with `return;` after CHAIN_DP_END,
    where every warp of the chain kernel has run its problem's DP: the
    kernel without its traceback, band fill and bound write. With
    `lookups`, each chunk also stores its matches' i ^ j (so that what
    finds and gathers them stays) and returns at CHUNK_DP_START: the
    chain pass's lookups and gathering of matches alone. None when `src`
    does not hold each mark it needs once."""
    marks = (CHAIN_DP_END, CHUNK_DP_START) if lookups else (CHAIN_DP_END,)
    if any(src.count(m) != 1 for m in marks):
        return None
    src = src.replace(CHAIN_DP_END, CHAIN_DP_END + "\n  return;")
    if lookups:
        src = src.replace(CHUNK_DP_START, CHUNK_DP_START
                          + "\n    if (lane < n) mi[base + lane] = ci ^ cj;"
                          "\n    return;")
    return src


def product_probe_source(src_path, lookups=False):
    """probe_source of the checkout's band_build.cu, which must hold its
    marks."""
    with open(src_path) as f:
        src = probe_source(f.read(), lookups)
    if src is None:
        fail(f"{src_path} does not mark its chain DP's end and its chunks' "
             "DP steps once each")
    return src


def band_split(lib, probes, args, index, route, expect=None, warmup=3,
               reps=15):
    """A band build of `lib` as the wrapper runs it (sw_cuda._launch_band),
    with CUDA events between its steps: the count pass, the device sum
    (torch.cumsum), the host read of the total (the card waits for it and
    the next launch), the chain pass (sw_cuda.band_chain on `route`); and
    the chain passes of `probes` (probe_source builds: "dp", the kernel
    stopped after its DP; "lookups", also without its DP steps; either
    None: not measured), timed in turns with it (full, dp, lookups,
    lookups, dp, full). Returns the medians in ms: SPLIT_PARTS, "total",
    "dp" and "lookups". `expect`: bounds the full build must equal."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    problems, per_read = sw_cuda.band_problems(*args, index)
    R, lx = args[0].shape
    P, H = per_read * R, args[1].shape[0]
    jlo = torch.empty((lx, P), dtype=torch.int32, device="cuda")
    jhi = torch.empty_like(jlo)
    counts = torch.empty(P, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(chain_lib):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        err = lib.band_build_count(*problems, counts.data_ptr(), stream)
        ev[1].record()
        ends = torch.cumsum(counts, 0)
        ev[2].record()
        total = int(ends[-1])
        ev[3].record()
        err = err or sw_cuda.band_chain(chain_lib, problems, P, H, ends,
                                        total, jlo, jhi, route)
        ev[4].record()
        ev[4].synchronize()
        if err:
            fail(f"band_build did not launch in the split ({err})")
        return [ev[k].elapsed_time(ev[k + 1]) for k in range(4)] + [
            ev[0].elapsed_time(ev[4])]

    libs = {"full": lib, **{k: v for k, v in probes.items() if v}}
    for _ in range(warmup):
        for which in libs.values():
            run(which)
    times = collections.defaultdict(list)
    for which in ("full", "dp", "lookups", "lookups", "dp", "full"):
        if which not in libs:
            continue
        for _ in range(reps):
            times[which].append(run(libs[which]))
        if which == "full" and expect is not None and not (
                torch.equal(jlo, expect[0]) and torch.equal(jhi, expect[1])):
            fail("band_build's bounds in the split differ from the wrapper's")
    out = {name: statistics.median(t[k] for t in times["full"])
           for k, name in enumerate(SPLIT_PARTS + ("total",))}
    for which in ("dp", "lookups"):
        out[which] = (statistics.median(t[3] for t in times[which])
                      if which in libs else None)
    return out


def log_split(name, split, ms, step_ms=None):
    """One line of a band build's split (band_split); step_ms: its DP
    steps at full issue, where known."""
    dp, chain, look = split["dp"], split["chain"], split["lookups"]
    steps = ""
    if look is not None:
        steps = (f"its lookups and gathering of matches (the lookups "
                 f"probe's chain pass) {look:.4f} ms, its DP steps (the DP "
                 f"probe's less the lookups probe's) {dp - look:.4f} ms"
                 + (f" against {step_ms:.4f} ms at full issue (issue "
                    f"efficiency {100 * step_ms / (dp - look):.1f} %)"
                    if step_ms else "") + "; ")
    log(f"timing {name} split: count pass {split['count']:.4f} ms, device "
        f"sum {split['device sum']:.4f} ms, host read of the total and the "
        f"next launch {split['host read']:.4f} ms, chain pass "
        f"{chain:.4f} ms (its DP, the chain DP probe's chain pass, "
        f"{dp:.4f} ms: {steps}traceback, band fill and bound write "
        f"{chain - dp:.4f} ms); total {split['total']:.4f} ms, the "
        f"wrapper's {ms:.4f} ms")


def mapping_split(path, lib, args, index, warmup=2, reps=10):
    """The chain DP under each mapping of MAPPING_LANES (the mapping
    probe at `path`: lookups, gathering and DP steps, no traceback), each
    problem's best match and checksum of predecessor distances held equal
    to the kernel's own chain DP (warp_dp_check), timed in turns (32, 16,
    8, 8, 16, 32). Returns {lanes: (median ms, SASS per candidate of its
    DP step)}."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    probe = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    probe.mapping_probe_launch.restype = ci
    probe.mapping_probe_launch.argtypes = [ci, vp, ci, ci, ci, vp, vp, ci,
                                           vp, vp, vp, vp, vp, vp, vp, vp,
                                           vp, vp]
    problems, per_read = sw_cuda.band_problems(*args, index)
    P = per_read * args[0].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    counts = torch.empty(P, dtype=torch.int64, device="cuda")
    if lib.band_build_count(*problems, counts.data_ptr(), stream):
        fail("band_build's count pass did not launch for the mapping probe")
    ends = torch.cumsum(counts, 0)
    matches = torch.empty((3, max(int(ends[-1]), 1)), dtype=torch.int32,
                          device="cuda")
    best = torch.empty(P, dtype=torch.int64, device="cuda")
    sums = torch.empty(P, dtype=torch.int32, device="cuda")

    def launch(lanes):
        if probe.mapping_probe_launch(
                lanes, *problems, ends.data_ptr(), matches[0].data_ptr(),
                matches[1].data_ptr(), matches[2].data_ptr(),
                best.data_ptr(), sums.data_ptr(), stream):
            fail(f"the mapping probe did not launch ({lanes} lanes)")

    launch(0)
    want = (best.clone(), sums.clone())
    for lanes in MAPPING_LANES:
        launch(lanes)
        if not (torch.equal(best, want[0]) and torch.equal(sums, want[1])):
            fail(f"the chain DP at {lanes} lanes per problem differs from "
                 "band_build's")
    times = collections.defaultdict(list)
    for lanes in MAPPING_LANES + MAPPING_LANES[::-1]:
        times[lanes].append(time_cuda(lambda: launch(lanes), warmup, reps))
    out = {}
    for lanes in MAPPING_LANES:
        n_instr, n, _ = max(sass_loops(path, f"group_dp_probeILi{lanes}E",
                                       CHAIN_OPCODE),
                            key=lambda t: (t[1], -t[0]))
        out[lanes] = (statistics.median(times[lanes]), n_instr / n * 32 / 64)
    return out


def index_launcher(lib, ht, route, routes=True):
    """One launch of `lib`'s band_index_build (a build of band_build.cu) on
    the haplotype matrix ht into buffers allocated here once (with scratch
    on the global route, and for a build without routes, whose only route
    merges in device memory): (launch(stream=None), the index).
    routes: whether the build takes a route code."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    H, ly = ht.shape
    index, tmp = sw_cuda.index_buffers(
        H, ly, route if routes else "global", ht.device)
    head = [ht.data_ptr(), H, ly, index.keys.data_ptr(),
            index.pos.data_ptr(), *(None if t is None else t.data_ptr()
                                    for t in tmp),
            index.hap_len.data_ptr()]
    if routes:
        head.append(sw_cuda.INDEX_ROUTES.index(route))
    default = torch.cuda.current_stream().cuda_stream

    def launch(stream=None):
        err = lib.band_index_build(*head,
                                   default if stream is None else stream)
        if err:
            fail(f"a band_index build did not launch ({route}): "
                 + lib.band_build_error_string(err).decode())

    return launch, index


def per_launch(launch, n=100, warmup=2, reps=7):
    """The median time of n back-to-back calls of launch(), over n (ms)."""
    def run():
        for _ in range(n):
            launch()

    return time_cuda(run, warmup, reps) / n


def graph_per_launch(launch, n=100):
    """n launches captured in one CUDA graph, replayed: the device's time
    per launch without the host's calls between them (ms)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(n):
            launch(stream)
    return time_cuda(graph.replay, 2, 7) / n


def launch_floor(path):
    """The empty kernel (EMPTY_SRC, built at `path`): (one launch through
    its C entry with CUDA events around the call, as the wrapper is timed;
    per launch of 100 back-to-back calls, as the kernel alone is) in ms."""
    import torch

    lib = ctypes.CDLL(path)
    lib.empty_launch.restype = ctypes.c_int
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if lib.empty_launch(1, stream):
            fail("the empty kernel did not launch")

    return time_cuda(launch, 3, 25), per_launch(launch)


def index_keys(ht):
    """The 6-mer keys a band_index of ht sorts: per row max(hap_len - 5,
    0), a numpy array."""
    import numpy as np

    from vartrix_tpu_torch.ops import band_torch

    return np.maximum(band_torch.true_lengths(ht, 1).cpu().numpy() - 5, 0)


def index_times(ht, floor):
    """band_index on ht, this checkout's path route: (the kernel alone,
    100 back-to-back band_index_build calls on buffers allocated once,
    per call; the same launches replayed from a CUDA graph; the wrapper,
    sw_cuda.band_index as the path calls it, CUDA events around one
    call), in ms, logged beside the shape, the key count and the launch
    floor (launch_floor's pair)."""
    from vartrix_tpu_torch.ops import sw_cuda

    route = sw_cuda.index_route(ht.shape[1])
    launch, _ = index_launcher(sw_cuda._band_kernel(), ht, route)
    kernel_ms = per_launch(launch)
    graph_ms = graph_per_launch(launch)
    ms = time_cuda(lambda: sw_cuda.band_index(ht), 3, 15)
    n = index_keys(ht)
    log(f"timing band_index H={ht.shape[0]} ly={ht.shape[1]} ({route} "
        f"route; {int((n > 0).sum())} rows with keys, {int(n.sum())} keys): "
        f"kernel alone {kernel_ms:.4f} ms (100 back-to-back calls; "
        f"{graph_ms:.4f} from a CUDA graph), wrapper {ms:.4f} ms; an empty "
        f"kernel {floor[0]:.4f} ms in one call, {floor[1]:.4f} back to back")
    return kernel_ms, graph_ms, ms


def index_route_widths(rng):
    """Both band_index routes' kernel alone, in turns (shared, global,
    global, shared), on rows of the main family's shape up to the shared
    route's limit: where the shared route stops being the faster, its
    limit would move there. Returns {ly: {route: ms}}."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    lib = sw_cuda._band_kernel()
    out = {}
    for H, ly in ((2048, MAIN_LY), (512, 1029), (128, 4032),
                  (64, sw_cuda.INDEX_SHARED_LY)):
        haps = rng.choice(np.frombuffer(b"ACGT", np.uint8), (H, ly))
        lens = rng.integers(ly * 4 // 5, ly + 1, H)
        haps[np.arange(ly)[None, :] >= lens[:, None]] = 1
        ht = torch.from_numpy(haps).cuda()
        runs = {r: index_launcher(lib, ht, r)[0] for r in sw_cuda.INDEX_ROUTES}
        times = collections.defaultdict(list)
        for route in ("shared", "global", "global", "shared"):
            times[route].append(per_launch(runs[route], 20, 1, 5))
        out[ly] = {r: statistics.median(t) for r, t in times.items()}
        log(f"timing band_index routes H={H} ly={ly}: kernel alone shared "
            f"{out[ly]['shared']:.4f} ms, global {out[ly]['global']:.4f} ms "
            "in turns (" + ", ".join(f"{r} {t:.4f}" for r, ts in times.items()
                                     for t in ts) + ")")
    return out


def time_index(ht, issue_per_s, empty_path, rng):
    """band_index on one bucket's haplotype matrix: the kernel alone and
    from a CUDA graph, the wrapper, the empty-launch floor, the plain
    version, and torch.sort of the same keys (the library call that sorts
    them; the port never calls it); then both routes by width
    (index_route_widths). Bound: the haplotype bytes read once and the
    index (12 bytes per key, 4 per row length) written once, against one
    placement per key and merge pass (n ceil(log2 n) per row) at the issue
    rate; its share of the kernel alone and of the wrapper."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import band_torch

    floor = launch_floor(empty_path)
    kernel_ms, graph_ms, ms = index_times(ht, floor)
    plain_ms = time_cuda(lambda: band_torch.band_index(ht), 1, 3)
    hap_len = band_torch.true_lengths(ht, 1)
    keys = band_torch.kmer_keys(ht, hap_len, (1 << 63) - 1)
    library_ms = time_cuda(lambda: torch.sort(keys, dim=1, stable=True),
                           3, 15)
    n = index_keys(ht)
    passes = np.ceil(np.log2(np.maximum(n, 1)))
    ops_ms = float((n * passes).sum()) / issue_per_s * 1e3
    nbytes = ht.numel() + 12 * int(n.sum()) + 4 * ht.shape[0]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"timing band_index plain {plain_ms:.3f} ms; torch.sort of the keys "
        f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({nbytes} bytes / "
        f"{HBM_BYTES_PER_S:.3g} B/s = {bytes_ms:.4f} ms; "
        f"{int((n * passes).sum())} placements / {issue_per_s:.6g} "
        f"instructions/s = {ops_ms:.4f} ms): "
        f"{100 * bound_ms / kernel_ms:.1f} % of the kernel alone, "
        f"{100 * bound_ms / ms:.1f} % of the wrapper; the launch floor "
        f"{floor[0]:.4f} ms alone is {floor[0] / bound_ms:.1f}x the bound")
    widths = index_route_widths(rng)
    return dict(ms=ms, kernel_ms=kernel_ms, graph_ms=graph_ms,
                launch_floor_ms=floor[0], launch_floor_back_to_back_ms=floor[1],
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=library_ms,
                share_of_bound=bound_ms / kernel_ms,
                wrapper_share_of_bound=bound_ms / ms,
                route_ms={str(k): v for k, v in widths.items()})


def time_buckets(mats, empty_path):
    """index_times on each haplotype matrix the path's band_index was given
    (recording_index), with the launch floor; returns [{H, ly, keys,
    kernel_ms, graph_ms, ms}]."""
    floor = launch_floor(empty_path)
    out = []
    for ht in mats:
        kernel_ms, graph_ms, ms = index_times(ht, floor)
        out.append(dict(H=ht.shape[0], ly=ht.shape[1],
                        keys=int(index_keys(ht).sum()), kernel_ms=kernel_ms,
                        graph_ms=graph_ms, ms=ms))
    return out


class recording_index:
    """Within it, every sw_cuda.band_index call keeps a copy of the
    haplotype matrix it was given (in .mats), in order."""

    def __enter__(self):
        from vartrix_tpu_torch.ops import sw_cuda

        self.mats, self._own = [], sw_cuda.band_index

        def band_index(hap_mat, **kw):
            self.mats.append(hap_mat.clone())
            return self._own(hap_mat, **kw)

        sw_cuda.band_index = band_index
        return self

    def __exit__(self, *exc):
        from vartrix_tpu_torch.ops import sw_cuda

        sw_cuda.band_index = self._own


def read_mtx(path):
    """(shape, {(row, col): value}) of a Matrix Market file."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if not ln.startswith("%")]
    r, c, _ = (int(v) for v in lines[0].split())
    entries = {}
    for ln in lines[1:]:
        i, j, v = ln.split()
        key = (int(i), int(j))
        entries[key] = entries.get(key, 0.0) + float(v)
    return (r, c), entries


def csr_equal(a, b):
    (sa, ea), (sb, eb) = read_mtx(a), read_mtx(b)
    if sa != sb or ea.keys() != eb.keys():
        return False
    return all(ea[k] == eb[k] or (math.isnan(ea[k]) and math.isnan(eb[k]))
               for k in ea)


def entries_differing(a, b):
    """Entries (row, col) whose values differ between two .mtx files."""
    (_, ea), (_, eb) = read_mtx(a), read_mtx(b)
    return sum(1 for k in ea.keys() | eb.keys()
               if not (k in ea and k in eb and (
                   ea[k] == eb[k]
                   or (math.isnan(ea[k]) and math.isnan(eb[k])))))


def write_cram_of(data):
    """data's BAM written as a CRAM beside it (rANS order 0 blocks,
    reference-based against its FASTA) with its .crai: (its path, seconds
    taken). Run in a worker process."""
    from vartrix_tpu_torch.io.bam import BamReader
    from vartrix_tpu_torch.io.cram import write_crai, write_cram

    t0 = time.perf_counter()
    b = BamReader(data["bam"])
    cram = os.path.join(os.path.dirname(data["bam"]), "reads.cram")
    write_cram(cram, list(zip(b.ref_names, b.ref_lens)), b.records(),
               fasta_path=data["fasta"], block_method="rans0")
    write_crai(cram, fasta_path=data["fasta"])
    return cram, time.perf_counter() - t0


def generate_e2e(work):
    """Phase 5's dataset (run in a worker process during phase 3): (the
    dataset's paths and read count, seconds taken)."""
    from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

    t0 = time.perf_counter()
    data = generate_dataset(os.path.join(work, "e2e"), SynthConfig(**E2E_CFG))
    data.pop("genotypes")
    return data, time.perf_counter() - t0


def generate_py_host(work):
    """Phase 7's --host python dataset as a BAM, a CRAM and the BAM's N
    copy (a third worker process, from phase 3): (the dataset with "cram"
    and "bam_n" added, seconds)."""
    from vartrix_tpu_torch.utils.synth import (SynthConfig, generate_dataset,
                                               with_n_bases)

    t0 = time.perf_counter()
    data = generate_dataset(os.path.join(work, "py_host"),
                            SynthConfig(**PY_HOST_CFG))
    data.pop("genotypes")
    data["cram"], _ = write_cram_of(data)
    data["bam_n"] = os.path.join(os.path.dirname(data["bam"]), "reads_n.bam")
    with_n_bases(data["bam"], data["bam_n"], N_READ_FRAC, N_READ_SEED)
    return data, time.perf_counter() - t0


def phase_e2e(work, data):
    """Both paths, full then banded, each in the three modes with --backend
    cuda and then torch (banded torch: consensus only, the plain banded
    version being slow), on generate_e2e's dataset. Every kernel's count is
    zeroed just before each (path, backend) group and read just after;
    returns the launches of the full path's cuda runs (sw_pair) and the
    banded path's (sw_banded, band_build, band_index), the matrices'
    paths by (sw_mode, mode, backend), each run's kernel_launches by tag
    and the haplotype matrices band_index was given (recording_index), one
    per shape bucket of each banded cuda run. The host band reference must
    never be called."""
    from vartrix_tpu_torch import driver
    from vartrix_tpu_torch.ops import sw_cuda, sw_native

    host_calls = [0]
    band_bounds = sw_native.band_bounds

    def counted_band_bounds(*args, **kwargs):
        host_calls[0] += 1
        return band_bounds(*args, **kwargs)

    sw_native.band_bounds = counted_band_bounds
    buckets = [0]
    pair_calls = sw_cuda.BandedSwBackend.pair_calls_chained

    def counted_pair_calls(self, *args):
        buckets[0] += 1
        return pair_calls(self, *args)

    sw_cuda.BandedSwBackend.pair_calls_chained = counted_pair_calls
    n_reads = data["n_reads"]
    modes = {"consensus": ["-s", "consensus"],
             "coverage_umi": ["-s", "coverage", "--umi"],
             "alt_frac": ["-s", "alt_frac"]}
    backends = {"cuda": ["--backend", "cuda"],
                "torch": ["--backend", "torch", "--device", "cuda"]}
    own = {"full": {"sw_pair"},
           "banded": {"sw_banded", "band_build", "band_index"}}
    outs = {}
    launches = {}
    n_buckets = {}
    run_launches = {}
    index_mats = []
    for sw_mode in own:
        for be, be_args in backends.items():
            launches[sw_mode, be] = collections.Counter()
            routes = {"read": collections.Counter(),
                      "hap": collections.Counter()}
            buckets[0] = 0
            for mode, mode_args in modes.items():
                if (sw_mode, be) == ("banded", "torch") and \
                        mode != "consensus":
                    continue  # the plain banded runs: one mode, for time
                tag = f"{sw_mode}_{mode}_{be}"
                out = os.path.join(work, f"{tag}.mtx")
                ref = os.path.join(work, f"{tag}_ref.mtx")
                mj = os.path.join(work, f"{tag}.json")
                argv = ["-v", data["vcf"], "-b", data["bam"], "-f",
                        data["fasta"], "-c", data["barcodes"], "-o", out,
                        "--ref-matrix", ref, "--sw-mode", sw_mode,
                        "--threads", str(os.cpu_count() or 1),
                        "--metrics-json", mj] + mode_args + be_args
                profiled = tag == "full_consensus_cuda"
                prof = os.path.join(work, f"{tag}_trace")
                if profiled:
                    argv += ["--profile-dir", prof]
                t0 = time.perf_counter()
                with recording_index() as rec:
                    driver._main(argv)
                dt = time.perf_counter() - t0
                index_mats += rec.mats
                with open(mj) as f:
                    payload = json.load(f)
                if profiled:
                    log(f"e2e {tag} ran under --profile-dir")
                    read_trace(os.path.join(prof, "score.pt.trace.json"),
                               "score", payload["kernel_launches"]["sw_pair"])
                shape = payload["matrix"]["shape"]
                if shape != [E2E_CFG["n_variants"], E2E_CFG["n_cells"]]:
                    fail(f"{tag}: matrix shape {shape}")
                log(f"e2e {tag}: {dt:.3f}s, {n_reads / dt:.0f} reads/s, nnz "
                    f"{payload['matrix']['nnz']}, launches "
                    f"{payload['kernel_launches']}, phases "
                    f"{payload['phase_seconds']}")
                outs[sw_mode, mode, be] = (out, ref)
                run_launches[tag] = payload["kernel_launches"]
                launches[sw_mode, be].update(payload["kernel_launches"])
                for kind, total in routes.items():
                    total.update(route_counts(kind))
            launches[sw_mode, be] = {
                k: launches[sw_mode, be][k]
                for k in ("sw_pair", "sw_banded", "band_build", "band_index")}
            n_buckets[sw_mode, be] = buckets[0]
            log(f"e2e {sw_mode} {be}: launches over the three runs "
                f"{launches[sw_mode, be]}; banded shape buckets "
                f"{buckets[0]}; read chunks by format "
                f"{dict(routes['read'])}, haplotype matrices "
                f"{dict(routes['hap'])}")
    for sw_mode, kernels in own.items():
        for be in backends:
            for name, n in launches[sw_mode, be].items():
                if (n > 0) != (be == "cuda" and name in kernels):
                    fail(f"--sw-mode {sw_mode} --backend {be}: {name} "
                         f"launched {n} times")
        for mode in modes:
            if (sw_mode, mode, "torch") not in outs:
                continue
            a, b = outs[sw_mode, mode, "cuda"], outs[sw_mode, mode, "torch"]
            ok = csr_equal(a[0], b[0])
            if mode == "coverage_umi":
                ok = ok and csr_equal(a[1], b[1])
            log(f"e2e {sw_mode} {mode}: cuda == torch (CSR, NaN-aware): {ok}")
            if not ok:
                fail(f"{sw_mode} {mode}: the kernel's matrices differ from "
                     "the plain version's")
    sw_native.band_bounds = band_bounds
    sw_cuda.BandedSwBackend.pair_calls_chained = pair_calls
    got, want = (launches["banded", "cuda"]["band_index"],
                 n_buckets["banded", "cuda"])
    log(f"e2e banded cuda: index launches {got}, shape buckets {want}")
    if got != want:
        fail("the band index was not built once per shape bucket")
    log(f"e2e: host band reference calls over every run: {host_calls[0]}")
    if host_calls[0]:
        fail("a run built band bounds on the host")
    for mode in modes:
        a, b = outs["banded", mode, "cuda"], outs["full", mode, "cuda"]
        log(f"e2e {mode}: banded vs full, entries differing: matrix "
            f"{entries_differing(a[0], b[0])}"
            + (f", ref matrix {entries_differing(a[1], b[1])}"
               if mode == "coverage_umi" else ""))
    return ({"sw_pair": launches["full", "cuda"]["sw_pair"],
             "sw_banded": launches["banded", "cuda"]["sw_banded"],
             "band_build": launches["banded", "cuda"]["band_build"],
             "band_index": launches["banded", "cuda"]["band_index"]},
            outs, run_launches, index_mats)


def launch_count(*kinds) -> int:
    """The recorder's launch.<kind> counters of `kinds`, summed."""
    from vartrix_tpu_torch.utils import trace

    c = trace.counters()
    return sum(c.get(f"launch.{k}", 0) for k in kinds)


def launch_counts() -> dict:
    """{kind: launches} of every LAUNCH_KINDS counter."""
    return {k: launch_count(k) for k in LAUNCH_KINDS}


def route_counts(kind: str) -> dict:
    """The recorder's read chunks ("read": p2, p4, dense) or haplotype
    matrices ("hap": p4, dense) by the format they shipped in."""
    from vartrix_tpu_torch.utils import trace

    c = trace.counters()
    names = ("p2", "p4", "dense") if kind == "read" else ("p4", "dense")
    return {r: c.get(f"route.{kind}.{r}", 0) for r in names}


def generate_n_reads(data):
    """Phase 5's N dataset (a worker process, once phase 5's BAM exists):
    its records rewritten with one base set to N in a seeded N_READ_FRAC
    of the reads (utils/synth.with_n_bases): (the dataset with that BAM,
    reads changed, seconds taken)."""
    from vartrix_tpu_torch.utils.synth import with_n_bases

    t0 = time.perf_counter()
    bam = os.path.join(os.path.dirname(data["bam"]), "reads_n.bam")
    n = with_n_bases(data["bam"], bam, N_READ_FRAC, N_READ_SEED)
    return dict(data, bam=bam), n, time.perf_counter() - t0


def phase_n_reads(work, data):
    """Phase 5's N dataset in full consensus, in-process: --backend cuda
    at PREFETCH_DEPTH 2, 0, 2, 0 unprofiled and then under --profile-dir
    (score's idle share, the trace's H2D bytes and copies), and --backend
    torch; every matrix CSR-equal to the torch run's, and every cuda run
    must ship 4-bit read chunks. Returns the sw_pair launches and the
    read and haplotype format counts of the first cuda run, and score's
    idle shares by depth."""
    from vartrix_tpu_torch import driver
    from vartrix_tpu_torch.ops import sw_cuda

    default = sw_cuda.PREFETCH_DEPTH

    def run(tag, extra, depth=default, profile=False):
        sw_cuda.PREFETCH_DEPTH = depth
        out = os.path.join(work, f"n_{tag}.mtx")
        mj = os.path.join(work, f"n_{tag}.json")
        argv = ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
                "-c", data["barcodes"], "-o", out, "-s", "consensus",
                "--threads", str(os.cpu_count() or 1), "--metrics-json",
                mj] + extra
        prof = os.path.join(work, f"n_{tag}_trace")
        if profile:
            argv += ["--profile-dir", prof]
        t0 = time.perf_counter()
        driver._main(argv)
        dt = time.perf_counter() - t0
        with open(mj) as f:
            payload = json.load(f)
        routes = route_counts("read")
        haps = route_counts("hap")
        log(f"n-reads {tag} (prefetch depth {depth}): {dt:.3f}s, score "
            f"{payload['phase_seconds']['score']} s, launches "
            f"{payload['kernel_launches']}, read chunks by format {routes}, "
            f"haplotype matrices {haps}, phases {payload['phase_seconds']}")
        summary = None
        if profile:
            summary = read_trace(os.path.join(prof, "score.pt.trace.json"),
                                 "score",
                                 payload["kernel_launches"]["sw_pair"])
        if extra[1] == "cuda" and not routes["p4"]:
            fail(f"n-reads {tag}: no read chunk shipped 4-bit")
        return out, payload, routes, haps, summary

    try:
        plain, _, plain_routes, _, _ = run(
            "torch", ["--backend", "torch", "--device", "cuda"])
        first = None
        shares = collections.defaultdict(list)
        for profile in (False, True):
            for turn, depth in enumerate((2, 0, 2, 0)):
                tag = (f"cuda_{turn}_d{depth}"
                       + ("_profiled" if profile else ""))
                out, payload, routes, haps, summary = run(
                    tag, ["--backend", "cuda"], depth, profile)
                first = first or (payload, routes, haps)
                ok = csr_equal(out, plain)
                log(f"n-reads {tag}: cuda == torch (CSR): {ok}")
                if not ok:
                    fail(f"n-reads {tag}: the kernel's matrix differs from "
                         "the plain version's")
                if summary is not None:
                    shares[depth].append(summary["idle_share"])
    finally:
        sw_cuda.PREFETCH_DEPTH = default
    log(f"n-reads: score's idle share by prefetch depth, in turns "
        f"(2, 0, 2, 0): {dict(shares)}; the torch run's read chunks "
        f"{plain_routes}")
    payload, routes, haps = first
    return payload["kernel_launches"]["sw_pair"], routes, haps, dict(shares)


def phase_cram_python(work, data, py, outs, run_launches):
    """Phase 7: phase 5's CRAM on the native host (full consensus with
    --fetch whole and auto, banded consensus), each CSR-equal to phase 5's
    BAM run of its mode with the same launches and libcramio's decode;
    then --host python on the 50,000-read BAM and CRAM (full consensus),
    BAM (banded consensus) and the BAM's N copy (full consensus: the
    native host must ship 4-bit read chunks and the Python host none
    through host_chunks), each CSR-equal to the native host's run on
    the same file, and the 50,000-read CRAM's .crai rebuilt by python -m
    vartrix_tpu_torch.io.bai. Every launch counter is zeroed just before
    each run and read just after; returns the Python host's launches
    (sw_pair on its full runs; sw_banded and band_build in their plain-row
    mode on the banded run)."""
    from vartrix_tpu_torch import driver
    from vartrix_tpu_torch.ops import sw_native

    t_start = time.perf_counter()
    host_calls = [0]
    band_bounds = sw_native.band_bounds

    def counted_band_bounds(*args, **kwargs):
        host_calls[0] += 1
        return band_bounds(*args, **kwargs)

    def run(tag, d, reads, *extra):
        out = os.path.join(work, f"p7_{tag}.mtx")
        mj = os.path.join(work, f"p7_{tag}.json")
        argv = ["-v", d["vcf"], "-b", reads, "-f", d["fasta"], "-c",
                d["barcodes"], "-o", out, "--threads",
                str(os.cpu_count() or 1), "--metrics-json", mj,
                "--backend", "cuda", *extra]
        t0 = time.perf_counter()
        driver._main(argv)  # zeroes the launch counters first
        dt = time.perf_counter() - t0
        n = launch_counts()
        with open(mj) as f:
            payload = json.load(f)
        log(f"cram/python {tag}: {dt:.3f}s, {d['n_reads'] / dt:.0f} reads/s, "
            f"nnz {payload['matrix']['nnz']}, cram_decode "
            f"{payload.get('cram_decode')}, counters {n}, phases "
            f"{payload['phase_seconds']}")
        return out, payload, n

    def same(tag, a, b):
        ok = csr_equal(a, b)
        log(f"cram/python {tag}: CSR-equal to its baseline: {ok}")
        if not ok:
            fail(f"phase 7 {tag}: the matrix differs from its baseline")

    sw_native.band_bounds = counted_band_bounds
    try:
        for tag, extra, base in (
                ("cram_full_whole", ("--fetch", "whole"), "full"),
                ("cram_full_auto", ("--fetch", "auto"), "full"),
                ("cram_banded_auto", ("--sw-mode", "banded"), "banded")):
            out, payload, n = run(tag, data, data["cram"], *extra)
            same(tag, out, outs[base, "consensus", "cuda"][0])
            want = run_launches[f"{base}_consensus_cuda"]
            got = {"sw_pair": n["sw_pair.pair"] + n["sw_pair.rows"],
                   "sw_banded": n["sw_banded.pair"],
                   "band_build": n["band_build.pair"],
                   "band_index": n["band_index"]}
            if got != want or payload.get("cram_decode") != "native":
                fail(f"phase 7 {tag}: launches {got} against the BAM run's "
                     f"{want}, CRAM decode {payload.get('cram_decode')}")
        py_launches = {}
        for tag, reads, extra in (
                ("py_bam_full", py["bam"], ()),
                ("py_cram_full", py["cram"], ()),
                ("py_bam_banded", py["bam"], ("--sw-mode", "banded")),
                ("py_bam_n_full", py["bam_n"], ())):
            base, _, _ = run(f"{tag}_native", py, reads, *extra)
            native_routes = route_counts("read")
            out, payload, n = run(f"{tag}_python", py, reads, "--host",
                                  "python", *extra)
            same(f"{tag}_python", out, base)
            if tag == "py_bam_n_full":
                routes = route_counts("read")
                log(f"cram/python {tag}: read chunks by format, native host "
                    f"{native_routes}, Python host {routes}")
                if not native_routes["p4"] or any(routes.values()):
                    fail(f"phase 7 {tag}: the native host must ship 4-bit "
                         "read chunks and the Python host dense rows")
            if payload["config"]["host"] != "python":
                fail(f"phase 7 {tag}: the run did not take the Python host")
            if "banded" in extra:
                ok = (min(n["sw_banded.rows"], n["band_build.rows"],
                          n["band_index"]) > 0
                      and n["sw_pair.pair"] + n["sw_pair.rows"]
                      == n["sw_banded.pair"] == n["band_build.pair"] == 0)
                py_launches["sw_banded_rows"] = n["sw_banded.rows"]
                py_launches["band_build_rows"] = n["band_build.rows"]
            else:
                ok = (n["sw_pair.pair"] + n["sw_pair.rows"] > 0
                      and n["sw_banded.rows"] == 0)
                py_launches[f"sw_pair_{tag}"] = (n["sw_pair.pair"]
                                                 + n["sw_pair.rows"])
            if not ok:
                fail(f"phase 7 {tag}: kernels launched {n}")
    finally:
        sw_native.band_bounds = band_bounds
    log(f"cram/python: host band reference calls {host_calls[0]}")
    if host_calls[0]:
        fail("a phase 7 run built band bounds on the host")

    # the 50,000-read CRAM: the writer's containers are multi-reference
    # slices, which the index decodes record by record in Python
    reindex = os.path.join(work, "reindex_cram")
    os.makedirs(reindex)
    cram2 = os.path.join(reindex, "reads.cram")
    os.link(py["cram"], cram2)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "vartrix_tpu_torch.io.bai", cram2,
                    "-f", py["fasta"]], cwd=HERE, check=True, timeout=600,
                   capture_output=True)
    with open(cram2 + ".crai", "rb") as f, \
            open(py["cram"] + ".crai", "rb") as g:
        a, b = f.read(), g.read()
    # the gzip member's header holds the time it was written (bytes 4-8)
    same_crai = a[:4] + a[8:] == b[:4] + b[8:]
    log(f"cram/python: python -m vartrix_tpu_torch.io.bai wrote the "
        f"{py['n_reads']}-read CRAM's .crai in {time.perf_counter() - t0:.1f}"
        f" s, byte-equal to the one written with the CRAM but for the gzip "
        f"timestamp: {same_crai}")
    if not same_crai:
        fail("the rebuilt .crai differs from the one written with the CRAM")
    log(f"cram/python: phase 7 took {time.perf_counter() - t_start:.1f} s")
    return py_launches


def phase_devices(work, data, outs, device="cuda"):
    """Phase 8: --device-agg, --mesh-devices and --distributed on phase 5's
    dataset, each matrix CSR-equal (NaN-aware) to phase 5's run of its
    mode without the option, every launch counter zeroed just before each
    run and read just after (its path's kernels must have launched); then
    in-process MeshSwBackend and build_sharded_step over two parts on this
    card against one SwBackend and one count_block; then two --distributed
    processes. Returns sw_pair's launches by full-mode run. (device "cpu"
    runs the same on the CPU with the plain versions, as a rehearsal; no
    kernel launches there.)"""
    import numpy as np
    import torch

    from vartrix_tpu_torch import driver
    from vartrix_tpu_torch.core import device_agg
    from vartrix_tpu_torch.ops import sw_cuda
    from vartrix_tpu_torch.parallel import mesh

    kernel = device == "cuda"
    dev_args = (("--backend", "cuda") if kernel else
                ("--device", "cpu", "--backend", "torch"))
    threads = str(os.cpu_count() or 1)
    modes = {"consensus": ["-s", "consensus"],
             "coverage_umi": ["-s", "coverage", "--umi"],
             "alt_frac": ["-s", "alt_frac"]}

    def argv(tag, mode, *extra):
        return ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
                "-c", data["barcodes"], "-o", os.path.join(work, f"{tag}.mtx"),
                "--ref-matrix", os.path.join(work, f"{tag}_ref.mtx"),
                "--metrics-json", os.path.join(work, f"{tag}.json"),
                *modes[mode], *extra]

    def same(tag, sw_mode, mode):
        a = outs[sw_mode, mode, "cuda"]
        ok = csr_equal(os.path.join(work, f"{tag}.mtx"), a[0])
        if mode == "coverage_umi":
            ok = ok and csr_equal(os.path.join(work, f"{tag}_ref.mtx"), a[1])
        log(f"devices {tag}: CSR-equal (NaN-aware) to phase 5's {sw_mode} "
            f"{mode} run: {ok}")
        if not ok:
            fail(f"phase 8 {tag}: the matrix differs from its baseline")

    def phases(tag):
        with open(os.path.join(work, f"{tag}.json")) as f:
            return json.load(f)

    launches = {}
    # full consensus twice, to tell the process's first --device-agg run
    # (the first use of its sums' device ops) from a later one
    runs = [(f"{sw}_{mode}_devagg{k}", sw, mode, ("--device-agg",))
            for sw, mode, k in (("full", "consensus", ""),
                                ("full", "consensus", "_again"),
                                ("full", "coverage_umi", ""),
                                ("full", "alt_frac", ""),
                                ("banded", "consensus", ""))]
    runs.append(("full_consensus_mesh1", "full", "consensus",
                 ("--mesh-devices", "-1")))
    for tag, sw_mode, mode, extra in runs:
        t0 = time.perf_counter()
        driver._main(argv(f"p8_{tag}", mode, "--sw-mode", sw_mode,
                          "--threads", threads, *dev_args, *extra))
        dt = time.perf_counter() - t0
        n = launch_counts()  # the run's: _main zeroes them first
        got = phases(f"p8_{tag}")["phase_seconds"]
        base = phases(f"{sw_mode}_{mode}_cuda")["phase_seconds"]
        log(f"devices {tag}: {dt:.3f}s, aggregate {got['aggregate']} s "
            f"(phase 5 without the option: {base['aggregate']} s), score "
            f"{got['score']} s (phase 5: {base['score']} s), counters {n}, "
            f"phases {got}")
        same(f"p8_{tag}", sw_mode, mode)
        kernels = (("sw_pair.pair",) if sw_mode == "full" else
                   ("sw_banded.pair", "band_build.pair", "band_index"))
        if kernel and (min(n[k] for k in kernels) == 0 or sum(n.values())
                       != sum(n[k] for k in kernels)):
            fail(f"phase 8 {tag}: kernels launched {n}")
        if sw_mode == "full":
            launches[tag] = n["sw_pair.pair"]

    # two parts on this card: the split, the gather and the sum
    rng = np.random.default_rng(8)
    x, haps, ir, ia = make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224))
    xp, lens = pack2(x)

    def provider(start, n):
        return x[start : start + n]

    provider.shape = x.shape
    provider.packed2 = lambda start, n: (xp[start : start + n],
                                         lens[start : start + n])
    x4 = x.copy()
    x4[rng.random(x4.shape) < 0.001] = ord("N")
    x4[x == 0] = 0
    xp4, lens4 = pack4(x4)

    def provider4(start, n):
        return x4[start : start + n]

    provider4.shape = x4.shape
    provider4.packed = lambda start, n: (xp4[start : start + n],
                                         lens4[start : start + n])
    two = [torch.device(device, 0) if kernel else torch.device("cpu")] * 2
    single = sw_cuda.SwBackend(device, kernel)
    split = sw_cuda.MeshSwBackend(two, kernel)
    for name, fn in (("scores", "pair_chained"),
                     ("codes", "pair_calls_chained")):
        for form, reads in (("dense", x), ("2bit", provider),
                            ("4bit", provider4)):
            want = getattr(single, fn)(x4 if form == "4bit" else reads,
                                       haps, ir, ia)
            got = getattr(split, fn)(reads, haps, ir, ia)
            ok = got.dtype == want.dtype and np.array_equal(got, want)
            log(f"devices MeshSwBackend(2 parts on {two[0]}) {name} {form}, "
                f"{len(x)} reads: equal to SwBackend: {ok}")
            if not ok:
                fail(f"phase 8: MeshSwBackend {name} ({form}) differs")
    n_rows, n_cells = 256, 512
    rows = rng.integers(0, n_rows, len(x)).astype(np.int32)
    cells = rng.integers(0, n_cells, len(x)).astype(np.int32)
    valid = rng.random(len(x)) < 0.99
    counts, n_reads = mesh.build_sharded_step(two, n_rows, n_cells)(
        x, haps, ir, ia, rows, cells, valid)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, two[0])
    want = device_agg.count_block(
        sw_cuda.pair_calls(xt, ht, irt, iat),
        torch.from_numpy(rows).to(two[0]), torch.from_numpy(cells).to(two[0]),
        torch.from_numpy(valid).to(two[0]), n_rows, n_cells)
    ok = (torch.equal(counts, want) and int(n_reads) == int(valid.sum()))
    log(f"devices build_sharded_step(2 parts on {two[0]}): counts "
        f"{counts.sum(dim=(0, 1)).tolist()}, n_reads {int(n_reads)}: equal "
        f"to one count_block of the whole batch: {ok}")
    if not ok:
        fail("phase 8: build_sharded_step differs from one count_block")

    # two processes on this card, rank r's outputs under its own names
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    half = str(max(1, (os.cpu_count() or 2) // 2))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vartrix_tpu_torch",
         *argv(f"p8_dist{r}", "coverage_umi", "--threads", half,
               *dev_args, "--log-level", "info",
               "--distributed", f"127.0.0.1:{port},2,{r}")],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]

    def wait(p):
        try:
            out, _ = p.communicate(timeout=600)
        finally:
            p.kill()
        return p.returncode, out, time.perf_counter() - t0

    with ThreadPoolExecutor(2) as ex:
        ends = list(ex.map(wait, procs))
    for r, (rc, out, wall) in enumerate(ends):
        log(f"devices distributed rank {r}: exit {rc}, wall {wall:.3f}s")
        if rc != 0:
            log(out[-3000:])
            fail(f"phase 8: --distributed rank {r} exited {rc}")
    same("p8_dist0", "full", "coverage_umi")
    got = phases("p8_dist0")
    base = phases("full_coverage_umi_cuda")
    log(f"devices distributed rank 0: metrics {got['metrics']}, launches "
        f"{got['kernel_launches']}, phases {got['phase_seconds']}")
    if got["metrics"] != base["metrics"]:
        fail("phase 8: the gathered metrics differ from the single run's")
    if kernel and got["kernel_launches"]["sw_pair"] == 0:
        fail("phase 8: rank 0 did not launch sw_pair")
    left = [f for f in os.listdir(work) if f.startswith("p8_dist1")]
    log(f"devices distributed rank 1: files written {left}")
    if left:
        fail("phase 8: rank 1 wrote outputs")
    launches["distributed_rank0"] = got["kernel_launches"]["sw_pair"]
    return launches


def phase_cli(work):
    """The user's entry point on a small dataset, in both --sw-mode values,
    against the plain version on the CPU."""
    from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

    data = generate_dataset(os.path.join(work, "small"), SynthConfig(
        n_variants=8, n_cells=25, reads_per_variant=25, seed=77,
        spliced_frac=0.3, indel_frac=0.2))
    base = ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
            "-c", data["barcodes"], "-s", "alt_frac", "--ref-matrix",
            os.path.join(work, "cli_ref.mtx")]
    for sw_mode in ("full", "banded"):
        out_gpu = os.path.join(work, f"cli_{sw_mode}_gpu.mtx")
        out_cpu = os.path.join(work, f"cli_{sw_mode}_cpu.mtx")
        for out, extra in ((out_gpu, []),
                           (out_cpu, ["--device", "cpu", "--backend",
                                      "torch"])):
            subprocess.run([sys.executable, "-m", "vartrix_tpu_torch", *base,
                            "-o", out, "--sw-mode", sw_mode, *extra],
                           cwd=HERE, check=True, timeout=300)
        with open(out_gpu, "rb") as f, open(out_cpu, "rb") as g:
            same = f.read() == g.read()
        log(f"cli: python -m vartrix_tpu_torch --sw-mode {sw_mode} on the "
            f"card == plain on the CPU (bytes): {same}")
        if not same:
            fail(f"the CLI's --sw-mode {sw_mode} kernel run differs from the "
                 "CPU plain run")


def read_trace(path, phase, sw_pair_launches):
    """The device's idle share in a profiled phase, from the port's chrome
    trace (vartrix_tpu_torch.utils.trace): the window is the phase's span,
    busy time the union of kernel, memcpy and memset intervals. Fails when
    the trace holds no sw_pair kernel or fewer than the run launched."""
    from vartrix_tpu_torch.utils import trace

    events = trace.load_events(path)
    s = trace.device_summary(events, phase)
    log(f"trace {phase}: window {s['window_us'] / 1e3:.3f} ms, device busy "
        f"{s['busy_us'] / 1e3:.3f} ms, idle share {s['idle_share']:.4f}; "
        f"the window's host time before the device's first interval "
        f"{s['lead_us'] / 1e3:.3f} ms, after its last "
        f"{s['tail_us'] / 1e3:.3f} ms")
    spans = [e for e in events if e.get("name") == trace.span_name(phase)
             and e.get("ph") == "X"]
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    out = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "gpu_memcpy"
           and not (float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"])
                    > w0)]
    log(f"trace {phase}:   copies outside the window: {len(out)}"
        + "".join(f"; {e['name']} {e.get('args', {}).get('bytes')} B at "
                  f"{(float(e['ts']) - w0) / 1e3:+.3f} ms"
                  for e in out[:8]))
    for name, k in sorted(s["kernels"].items(), key=lambda kv: -kv[1]["us"]):
        short = re.sub(r"\((?!anonymous)[^()]*\)$", "", name)
        log(f"trace {phase}:   kernel {short}: {k['n']} launches, "
            f"{k['us'] / 1e3:.4f} ms")
    for d, c in sorted(s["copies"].items()):
        log(f"trace {phase}:   memcpy {d}: {c['n']} copies, "
            f"{c['us'] / 1e3:.4f} ms, {c['bytes']} bytes")
    log(f"trace {phase}:   memset {s['memset_us'] / 1e3:.4f} ms")
    n = trace.kernel_count(s, "sw_pair")
    if n == 0 or n < sw_pair_launches:
        fail(f"the {phase} trace holds {n} sw_pair kernels, the run "
             f"launched {sw_pair_launches}")
    return s


def generate_sparse(work):
    """Phase 6's dataset (a second worker process during phase 3): (the
    dataset's paths and read count, seconds taken)."""
    from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

    t0 = time.perf_counter()
    data = generate_dataset(os.path.join(work, "sparse"),
                            SynthConfig(**SPARSE_CFG))
    data.pop("genotypes")
    return data, time.perf_counter() - t0


def run_vartrix(work, tag, argv, rows):
    """`python -m vartrix_tpu_torch` in a process of its own (RSS_WRAPPER):
    its metrics payload and stderr. Appends (tag, wall s, phase seconds,
    records decoded, strategy, peak RSS MiB, peak after start-up) to
    rows."""
    mj = os.path.join(work, f"{tag}.json")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", RSS_WRAPPER, *argv,
                        "--metrics-json", mj, "--log-level", "info"],
                       cwd=HERE, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        log(r.stdout[-4000:])
        log(r.stderr[-4000:])
        fail(f"phase 6 {tag}: exit code {r.returncode}")
    m = re.search(r"peak_rss_kb (\d+) start_rss_kb (\d+) run_peak_rss_kb "
                  r"(\d+)", r.stderr)
    rss, start, run_peak = (int(m.group(i)) / 1024 for i in (1, 2, 3))
    decoded = re.findall(r"Decoded (\d+) records \(strategy: ([^)]+)\)",
                         r.stderr)
    if len(decoded) != 1:
        fail(f"phase 6 {tag}: no single decode line in the log")
    n, strategy = int(decoded[0][0]), decoded[0][1]
    with open(mj) as f:
        payload = json.load(f)
    after = f"{run_peak:.1f} MiB from {start:.1f} MiB at start-up"
    log(f"sparse {tag}: wall {wall:.3f} s, phases "
        f"{payload['phase_seconds']}, records decoded {n} ({strategy}), "
        f"peak RSS {rss:.1f} MiB, sampled after start-up {after}, launches "
        f"{payload['kernel_launches']}")
    rows.append((tag, wall, payload["phase_seconds"], n, strategy, rss,
                 after))
    return payload, r.stderr


def baseline_rss():
    """Peak RSS (MiB) of a process that imports torch, creates the CUDA
    context and loads sw_pair's library, and does nothing else: the floor
    under every phase-6 run's."""
    code = ("import resource, torch\n"
            "from vartrix_tpu_torch.ops import sw_cuda\n"
            "torch.zeros(1, device='cuda')\n"
            "sw_cuda._kernel()\n"
            "print(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE, check=True,
                       capture_output=True, text=True, timeout=300)
    return int(r.stdout.split()[-1]) / 1024


def check_columns_bounded(bam, threads):
    """The bounded-memory whole-file loader forced on (threshold 0, 16 MiB
    segments) against the monolithic load: every column equal."""
    import numpy as np

    from vartrix_tpu_torch.io import bam_native

    t0 = time.perf_counter()
    mono = bam_native.ColumnarBam(bam, b"CB", threads)
    t1 = time.perf_counter()
    saved = bam_native.STREAM_DECODE_BYTES, bam_native.STREAM_SEGMENT_BYTES
    bam_native.STREAM_DECODE_BYTES = 0
    bam_native.STREAM_SEGMENT_BYTES = 16 << 20
    try:
        bounded = bam_native.ColumnarBam(bam, b"CB", threads)
    finally:
        bam_native.STREAM_DECODE_BYTES, bam_native.STREAM_SEGMENT_BYTES = saved
    t2 = time.perf_counter()
    if (mono.loader, bounded.loader) != ("whole", "bounded"):
        fail(f"loaders taken: {mono.loader}, {bounded.loader}")
    same = mono.n == bounded.n and all(
        np.array_equal(getattr(mono, c), getattr(bounded, c))
        for c in ("tid", "pos", "ref_end", "mapq", "flag", "seq_off",
                  "seq_pool", "itv_off", "itv_pool", "cb_off", "cb_pool",
                  "ub_off", "ub_pool"))
    log(f"sparse bounded loader (16 MiB segments) vs monolithic: {mono.n} "
        f"records, {t2 - t1:.3f} s vs {t1 - t0:.3f} s, every column equal: "
        f"{same}")
    if not same:
        fail("the bounded-memory loader's columns differ from the "
             "monolithic load's")


def phase_sparse(work, data, device_args=("--backend", "cuda"),
                 plain_args=("--backend", "torch", "--device", "cuda")):
    """Phase 6: the input and run-control surface on a sparse dataset, each
    run its own process. Every matrix must be CSR-equal to its mode's
    --fetch whole run, which is CSR-equal to the plain version's."""
    from vartrix_tpu_torch.driver import AUTO_REGION_BYTES
    from vartrix_tpu_torch.io.bcf import write_bcf
    from vartrix_tpu_torch.io.vcf import read_vcf_records

    size = os.path.getsize(data["bam"])
    log(f"sparse: {data['n_reads']} reads, BAM {size} bytes "
        f"({size / 2 ** 20:.1f} MiB), {SPARSE_CFG['n_variants']} variants")
    if size < AUTO_REGION_BYTES:
        fail(f"the sparse BAM is under --fetch auto's {AUTO_REGION_BYTES} "
             "byte threshold")
    threads = str(os.cpu_count() or 1)
    base = ["-f", data["fasta"], "-c", data["barcodes"], "--threads", threads]
    rows = []

    def run(tag, *extra, vcf=data["vcf"], bam=data["bam"], dev=device_args):
        out = os.path.join(work, f"sp_{tag}.mtx")
        argv = ["-v", vcf, "-b", bam, *base, "-o", out, "--ref-matrix",
                os.path.join(work, f"sp_{tag}_ref.mtx"), *dev, *extra]
        payload, err = run_vartrix(work, f"sp_{tag}", argv, rows)
        kernels = ("sw_banded" if "banded" in extra else "sw_pair")
        if "torch" not in dev and payload["kernel_launches"][kernels] == 0 \
                and "--checkpoint-dir" not in extra:
            fail(f"phase 6 {tag}: {kernels} never launched")
        return out, payload, err

    def same(tag, a, b, ref=False):
        ok = csr_equal(a, b)
        if ref:
            ok = ok and csr_equal(a[:-4] + "_ref.mtx", b[:-4] + "_ref.mtx")
        log(f"sparse {tag}: CSR-equal to its baseline: {ok}")
        if not ok:
            fail(f"phase 6 {tag}: the matrix differs from its baseline")

    base_rss = baseline_rss()
    log(f"sparse baseline: a process that imports torch, creates the CUDA "
        f"context and loads sw_pair's library peaks at {base_rss:.1f} MiB")
    whole, w_pl, _ = run("whole", "--fetch", "whole")
    plain, _, _ = run("whole_torch", "--fetch", "whole", dev=plain_args)
    same("whole_torch (the plain version)", plain, whole)
    auto, a_pl, a_err = run("auto")
    if a_pl["config"]["fetch"] != "auto" or \
            "(strategy: regions)" not in a_err:
        fail("--fetch auto did not take regions on the sparse dataset")
    same("auto", auto, whole)
    regions, _, _ = run("regions", "--fetch", "regions")
    same("regions", regions, whole)
    b_whole, _, _ = run("banded_whole", "--sw-mode", "banded", "--fetch",
                        "whole")
    b_regions, _, _ = run("banded_regions", "--sw-mode", "banded", "--fetch",
                          "regions")
    same("banded_regions", b_regions, b_whole)
    stream, _, _ = run("stream", "--stream", str(SPARSE_WINDOW))
    same("stream", stream, whole)
    prof = os.path.join(work, "sp_stream_trace")
    p_stream, s_pl, _ = run("stream_profiled", "--stream",
                            str(SPARSE_WINDOW), "--profile-dir", prof)
    same("stream_profiled", p_stream, whole)
    if "torch" not in device_args:
        read_trace(os.path.join(prof, "stream.pt.trace.json"), "stream",
                   s_pl["kernel_launches"]["sw_pair"])
    b_stream, _, _ = run("banded_stream", "--sw-mode", "banded", "--stream",
                         str(SPARSE_WINDOW))
    same("banded_stream", b_stream, b_whole)
    cov = ("-s", "coverage", "--umi")
    c_whole, _, _ = run("cov_umi_whole", *cov, "--fetch", "whole")
    c_stream, _, _ = run("cov_umi_stream", *cov, "--stream",
                         str(SPARSE_WINDOW))
    same("cov_umi_stream", c_stream, c_whole, ref=True)

    bcf = os.path.join(work, "sparse.bcf")
    write_bcf(bcf, [(c, SPARSE_CFG["chrom_len"]) for c in data["chroms"]],
              read_vcf_records(data["vcf"]))
    b_out, _, _ = run("bcf_auto", "--fetch", "auto", vcf=bcf)
    same("bcf_auto", b_out, whole)

    parts = [run(f"shard{i}", "--num-shards", "4", "--shard-index",
                 str(i))[0] for i in range(4)]
    merged = os.path.join(work, "sp_merged.mtx")
    subprocess.run([sys.executable, "-m",
                    "vartrix_tpu_torch.parallel.multihost", merged, *parts],
                   cwd=HERE, check=True, timeout=300)
    same("4 shards merged", merged, whole)

    reindex = os.path.join(work, "reindex")
    os.makedirs(reindex)
    bam2 = os.path.join(reindex, "reads.bam")
    os.link(data["bam"], bam2)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "vartrix_tpu_torch.io.bai", bam2],
                   cwd=HERE, check=True, timeout=600, capture_output=True)
    with open(bam2 + ".bai", "rb") as f, open(data["bam"] + ".bai", "rb") as g:
        same_bai = f.read() == g.read()
    log(f"sparse: python -m vartrix_tpu_torch.io.bai rebuilt the .bai in "
        f"{time.perf_counter() - t0:.1f} s, equal to the written one: "
        f"{same_bai}")
    if not same_bai:
        fail("the rebuilt .bai differs from the one written with the BAM")
    r_out, _, _ = run("reindexed_regions", "--fetch", "regions", bam=bam2)
    same("reindexed_regions", r_out, whole)

    ck = os.path.join(work, "sp_ck")
    ck1, c1, _ = run("checkpoint1", "--checkpoint-dir", ck)
    ck2, c2, err2 = run("checkpoint2", "--checkpoint-dir", ck)
    n1, n2 = (c["kernel_launches"]["sw_pair"] for c in (c1, c2))
    with open(ck1, "rb") as f, open(ck2, "rb") as g:
        same_bytes = f.read() == g.read()
    log(f"sparse checkpoint: sw_pair launches {n1} then {n2}, second "
        f"matrix byte-equal to the first: {same_bytes}")
    if "torch" not in device_args and (n1 == 0 or n2 != 0):
        fail("the checkpoint rerun launched sw_pair")
    if "variants loaded, 0 scored" not in err2 or not same_bytes:
        fail("the checkpoint rerun scored variants or wrote another matrix")
    same("checkpoint2", ck2, whole)

    check_columns_bounded(data["bam"], int(threads))
    log("sparse table: run | wall s | phase seconds | records decoded "
        "(strategy) | peak RSS MiB | sampled peak RSS after start-up")
    for tag, wall, phases, n, strategy, rss, after in rows:
        log(f"sparse table: {tag} | {wall:.3f} | "
            + ", ".join(f"{k} {v}" for k, v in phases.items())
            + f" | {n} ({strategy}) | {rss:.1f} | {after}")


# Copies of sw_banded.cu's packed route for its time split and its
# choices (--band): probes, whose outputs are not the kernel's, with its
# scratch traffic cut (no word stored or loaded, so every strip starts as
# the first does) and with every thread's haplotype rows replaced by the
# matrix's first two (a warp's haplotype loads then touch one line); and
# the kernel with another strip height or blocks per SM, exact. Each a
# list of (line, replacement), skipped where the source lacks a line.
STRIP_LINE = "constexpr int kStrip = 8;           // read rows per strip"
BLOCKS_LINE = "constexpr int kPackedBlocks = 4;"
BANDED_VARIANTS = {
    "no scratch": [
        ("        col_out[(kCols * m + d) * stride] = "
         "make_uint2(g[kStrip - 1], f);",
         "        if (g[kStrip - 1] == 0x7fff7fffu) col_out[(kCols * m + d) * "
         "stride] = make_uint2(g[kStrip - 1], f);"),
        ("  return off < static_cast<unsigned>(pv_w) ? col_in[off * stride]",
         "  return off < static_cast<unsigned>(pv_w) && pv_w < 0 ? "
         "col_in[off * stride]")],
    "one haplotype pair": [
        ("haps + static_cast<size_t>(hidx0) * ly,\n"
         "      haps + static_cast<size_t>(hidx1) * ly", "haps, haps + ly")],
    "6-row strips": [(STRIP_LINE, "constexpr int kStrip = 6;")],
    "12-row strips": [(STRIP_LINE, "constexpr int kStrip = 12;")],
    "16-row strips, 3 blocks per SM": [
        (STRIP_LINE, "constexpr int kStrip = 16;"),
        (BLOCKS_LINE, "constexpr int kPackedBlocks = 3;")],
    "5 blocks per SM": [(BLOCKS_LINE, "constexpr int kPackedBlocks = 5;")],
}


# Copies of band_build.cu for band_index's split (index_split): its sort
# skipped (a probe: the rows come out unsorted), and other thread and row
# mappings of the shared route (exact: the same index).
INDEX_VARIANTS = {
    "no sort": [("  while (size < n) size <<= 1;\n", "")],
    "4 keys a thread": [("constexpr int kSortPerThread = 8;",
                         "constexpr int kSortPerThread = 4;")],
    "4 rows a block": [("constexpr int kSortWarpRows = 8;",
                        "constexpr int kSortWarpRows = 4;")],
    "16 rows a block": [("constexpr int kSortWarpRows = 8;",
                         "constexpr int kSortWarpRows = 16;")],
}


def variant_sources(path, variants):
    """{name: the source at `path` with each of the variant's (old, new)
    edits}; a variant whose old text is not in the source exactly once is
    logged and left out."""
    with open(path) as f:
        src = f.read()
    sources = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            text = text.replace(old, new) if text.count(old) == 1 else None
            if text is None:
                break
        if text is None:
            log(f"no {name} variant of {os.path.basename(path)} (a line is "
                "missing from the source), not measured")
        else:
            sources[name] = text
    return sources


def index_split(rng):
    """band_index's shared route at the main shape against its variants
    (INDEX_VARIANTS), the kernel alone and from a CUDA graph in turns
    (kernel, variants, variants reversed, kernel): the sort's share and
    other mappings (those must give the kernel's index); then the
    wrapper's host time by step (time.perf_counter over 200 calls each,
    the host alone, not the device): checks, the buffers as three
    allocations (the wrapper's) and as one allocation cut into views, the
    stream lookup, the C call, and the whole wrapper."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import _build, sw_cuda

    sources = variant_sources(_build.BAND_BUILD_SRC, INDEX_VARIANTS)
    with ThreadPoolExecutor(len(sources)) as ex:
        built = {name: ex.submit(build_probe, "index_" + re.sub(
            r"\W+", "_", name), text, "-shared")
            for name, text in sources.items()}
        libs = {"kernel": sw_cuda._band_kernel()}
        libs.update({name: sw_cuda.bind_band_library(f.result())
                     for name, f in built.items()})
    _, haps, _, _ = make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                                read_len=(140, 150), hap_len=(180, 224))
    ht = torch.from_numpy(haps).cuda()
    runs = {who: index_launcher(lib, ht, "shared") for who, lib in
            libs.items()}
    for launch, _ in runs.values():
        launch()
    torch.cuda.synchronize()
    order = list(libs)
    times = collections.defaultdict(list)
    graphs = collections.defaultdict(list)
    for who in ["kernel"] + order[1:] + order[1:][::-1] + ["kernel"]:
        times[who].append(per_launch(runs[who][0]))
        graphs[who].append(graph_per_launch(runs[who][0]))
    ms = {who: statistics.median(t) for who, t in times.items()}
    gms = {who: statistics.median(t) for who, t in graphs.items()}
    n = torch.from_numpy(index_keys(ht)).cuda()
    valid = torch.arange(ht.shape[1], device="cuda")[None, :] < n[:, None]
    own = runs["kernel"][1]
    exact = {who: torch.equal(idx.keys[valid], own.keys[valid])
             and torch.equal(idx.pos[valid], own.pos[valid])
             and torch.equal(idx.hap_len, own.hap_len)
             for who, (_, idx) in runs.items()}
    log(f"timing band_index split H={ht.shape[0]} ly={ht.shape[1]}: kernel "
        f"alone {ms['kernel']:.4f} ms ({gms['kernel']:.4f} from a graph); "
        + "; ".join(f"{name} {ms[name]:.4f} ms ({gms[name]:.4f}; the kernel "
                    f"{gms['kernel'] - gms[name]:+.4f} from a graph; "
                    + ("exact" if exact[name] else "index differs") + ")"
                    for name in order[1:]))
    for name in order[1:]:
        if name != "no sort" and not exact[name]:
            fail(f"band_index's {name} variant is not exact")
    dev = ht.device
    H, ly = ht.shape
    launch = runs["kernel"][0]

    def host_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    def views():
        buf = torch.empty(3 * H * ly + H, dtype=torch.int32, device=dev)
        return (buf[:2 * H * ly].view(torch.int64).view(H, ly),
                buf[2 * H * ly:3 * H * ly].view(H, ly), buf[3 * H * ly:])

    steps = {
        "checks": lambda: sw_cuda._check(ht, "hap_mat", torch.uint8, 2, dev),
        "three allocations (the wrapper's)": lambda: sw_cuda.index_buffers(
            H, ly, "shared", dev),
        "one buffer cut into views": views,
        "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "the C call": launch,
        "wrapper": lambda: sw_cuda.band_index(ht),
    }
    host = {name: host_us(fn) for name, fn in steps.items()}
    log("timing band_index wrapper, host us per call: " + "; ".join(
        f"{name} {us:.2f}" for name, us in host.items()))
    return dict(ms=ms, graph_ms=gms, host_us=host)


def banded_split(rng):
    """sw_banded's packed route at the main shape against its variants
    (BANDED_VARIANTS), each a single launch over the whole chunk, in turns
    (kernel, variants, variants reversed, kernel) in both per_read modes:
    the time its scratch traffic and its haplotype loads take, and its
    strip height and blocks per SM against others (those exact to the
    kernel's output, the probes not)."""
    import torch

    from vartrix_tpu_torch.ops import _build, sw_cuda

    sources = variant_sources(_build.BANDED_KERNEL_SRC, BANDED_VARIANTS)
    with ThreadPoolExecutor(len(sources)) as ex:
        built = {name: ex.submit(build_probe, "banded_" + re.sub(
            r"\W+", "_", name), text, "-shared")
            for name, text in sources.items()}
        libs = {"kernel": sw_cuda._banded_kernel()}
        for name, fut in built.items():
            lib = ctypes.CDLL(fut.result())
            lib.sw_banded_launch.restype = ctypes.c_int
            lib.sw_banded_launch.argtypes = (
                libs["kernel"].sw_banded_launch.argtypes)
            libs[name] = lib
    x, haps, ir, ia = make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224))
    args = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    pair = tuple(args) + tuple(sw_cuda.band_bounds(*args))
    xr = args[0].repeat_interleave(2, dim=0)
    yr = args[1][torch.stack([args[2], args[3]], 1).reshape(-1).long()]
    ident = torch.arange(len(xr), dtype=torch.int32, device="cuda")
    rows = (xr, yr, ident, None) + pair[4:]
    route = sw_cuda.PAIR_ROUTES.index("packed")
    for mode, a, per_read in (("pair", pair, 2), ("rows", rows, 1)):
        times = collections.defaultdict(list)
        order = list(libs)
        out = {}
        for who in ["kernel"] + order[1:] + order[1:][::-1] + ["kernel"]:
            times[who].append(time_cuda(lambda: banded_ab_launch(
                libs[who], a, per_read, per_read == 2, route), 3, 15))
            out[who] = banded_ab_launch(libs[who], a, per_read,
                                        per_read == 2, route)
        ms = {who: statistics.median(t) for who, t in times.items()}
        log(f"timing sw_banded split, {mode}: kernel {ms['kernel']:.4f} ms; "
            + "; ".join(f"{name} {ms[name]:.4f} ms (the kernel "
                        f"{ms['kernel'] - ms[name]:+.4f}; "
                        + ("exact" if torch.equal(out[name], out["kernel"])
                           else "output differs") + ")"
                        for name in order[1:]))
        for name in order[1:]:
            if "strip" in name or "blocks" in name:
                if not torch.equal(out[name], out["kernel"]):
                    fail(f"sw_banded's {name} variant is not exact")


def banded_ab_launch(lib, args, per_read, codes, last_int):
    """One launch of a build of csrc/sw_banded.cu (`lib`, its C entry
    typed as sw_cuda types it) on `args` (reads, haplotype rows, idx_ref,
    idx_alt or None, jlo, jhi on the card) over all its reads, its scratch
    the larger of a scalar route's and the packed route's; last_int: the
    entry's int before the stream (a route's code; in a parent checkout
    without routes, its 64-bit-word flag). Returns its output."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    reads, hap, ir, ia, jlo, jhi = args
    R, lx = reads.shape
    ly = hap.shape[1]
    P = per_read * R
    scratch = torch.empty(max(8 * ly * P, 16 * (-(-ly // 2) * 2)
                              * -(-P // 2)), dtype=torch.uint8,
                          device="cuda")
    if codes:
        out = torch.empty(R, dtype=torch.int8, device="cuda")
    else:
        out = torch.empty((per_read, R), dtype=torch.int32, device="cuda")
    err = lib.sw_banded_launch(
        reads.data_ptr(), R, lx, hap.data_ptr(), ly, ir.data_ptr(),
        None if ia is None else ia.data_ptr(), per_read, jlo.data_ptr(),
        jhi.data_ptr(), P, None if codes else out.data_ptr(), R,
        out.data_ptr() if codes else None, scratch.data_ptr(), last_int,
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"a sw_banded build did not launch ({err})")
    return out


def baseline_index_wrapper(lib, ht):
    """The band_index wrapper of a checkout whose index build has no routes
    (ops/sw_cuda._launch_index as of 0b121ac), on `lib`, a build of that
    checkout's band_build.cu: the checks, five allocations (hap_len by a
    zero fill), then the build."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    dev = ht.device
    sw_cuda._check(ht, "hap_mat", torch.uint8, 2, dev)
    H, ly = ht.shape
    keys = torch.empty((H, ly), dtype=torch.int64, device=dev)
    pos = torch.empty((H, ly), dtype=torch.int32, device=dev)
    hap_len = torch.zeros(H, dtype=torch.int32, device=dev)
    tmp_keys = torch.empty_like(keys)
    tmp_pos = torch.empty_like(pos)
    err = lib.band_index_build(
        ht.data_ptr(), H, ly, keys.data_ptr(), pos.data_ptr(),
        tmp_keys.data_ptr(), tmp_pos.data_ptr(), hap_len.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        fail(f"the baseline's band_index did not launch ({err})")


def index_ab(lib, routes, mats, floor):
    """band_index of this checkout against `lib`, a build of another
    checkout's band_build.cu (routes: whether its build takes a route
    code), on each haplotype matrix of `mats`, in turns (baseline, this,
    this, baseline): the kernel alone (per_launch, on buffers allocated
    once; the baseline on its own route for the width, its global merge
    passes where it has no routes) and, for a baseline without routes,
    the wrappers (baseline_index_wrapper against sw_cuda.band_index); the
    indexes held equal. floor: launch_floor's pair. Returns [{H, ly, keys,
    kernel: {who: ms}, wrapper: {who: ms}}]."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    out = []
    for ht in mats:
        route = sw_cuda.index_route(ht.shape[1])
        launches, indexes = {}, {}
        for who, (l, r) in (("baseline", (lib, routes)),
                            ("this", (sw_cuda._band_kernel(), True))):
            launches[who], indexes[who] = index_launcher(l, ht, route, r)
            launches[who]()
        torch.cuda.synchronize()
        n = torch.from_numpy(index_keys(ht)).to(ht.device)
        valid = torch.arange(ht.shape[1], device=ht.device)[None, :] < \
            n[:, None]
        a, b = indexes["baseline"], indexes["this"]
        if not (torch.equal(a.hap_len, b.hap_len)
                and torch.equal(a.keys[valid], b.keys[valid])
                and torch.equal(a.pos[valid], b.pos[valid])):
            fail(f"band_index differs from the baseline's (H={ht.shape[0]}, "
                 f"ly={ht.shape[1]})")
        wrappers = {"this": lambda: sw_cuda.band_index(ht)}
        if not routes:
            wrappers["baseline"] = lambda: baseline_index_wrapper(lib, ht)
        kernel, wrapper = (collections.defaultdict(list),
                           collections.defaultdict(list))
        for who in ("baseline", "this", "this", "baseline"):
            kernel[who].append(per_launch(launches[who]))
            if who in wrappers:
                wrapper[who].append(time_cuda(wrappers[who], 3, 15))
        res = dict(H=ht.shape[0], ly=ht.shape[1], keys=int(n.sum().item()),
                   kernel={w: statistics.median(t) for w, t in kernel.items()},
                   wrapper={w: statistics.median(t)
                            for w, t in wrapper.items()})
        out.append(res)
        log(f"band_index H={res['H']} ly={res['ly']} ({res['keys']} keys, "
            f"{route} route here): kernel alone, this checkout "
            f"{res['kernel']['this']:.4f} ms against the baseline's "
            f"{res['kernel']['baseline']:.4f} in turns ("
            + ", ".join(f"{who} {t:.4f}" for who in ("baseline", "this")
                        for t in kernel[who]) + "); wrapper "
            + ", ".join(f"{who} {res['wrapper'][who]:.4f} ms ("
                        + ", ".join(f"{t:.4f}" for t in wrapper[who]) + ")"
                        for who in ("baseline", "this") if who in wrapper)
            + f"; an empty kernel {floor[0]:.4f} ms in one call, "
            f"{floor[1]:.4f} back to back; indexes equal")
    return out


def band_ab(baseline, rng, probes, buckets):
    """band_build, sw_banded and band_index of this checkout against those
    of `baseline` (the root of another checkout, e.g. the parent commit's,
    unpacked by git archive) in one process: both sources built here, then
    at the main bucket shape in both per_read modes, in turns (baseline,
    this, this, baseline). band_build: each build's split (band_split, a
    part whose mark the baseline lacks not measured), the bounds equal.
    sw_banded on those bounds: the baseline's build given 0 for its last
    int (the 32-bit scratch word of a parent without routes, the packed
    route of one with them) against this checkout's path route, the
    outputs equal. band_index (index_ab) on the main family's haplotypes
    and on `buckets`, the matrices of phase 5's banded run."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda

    sources = {}
    for name, stem in (("band_build", "band_build.cu"),
                       ("sw_banded", "sw_banded.cu")):
        with open(os.path.join(baseline, "vartrix_tpu_torch", "csrc",
                               stem)) as f:
            sources[f"baseline_{name}"] = f.read()
    src = sources["baseline_band_build"]
    sources.update(baseline_chain_dp_probe=probe_source(src),
                   baseline_lookups_probe=probe_source(src, lookups=True))
    with ThreadPoolExecutor(len(sources)) as ex:
        built = {name: ex.submit(build_probe, name, text, "-shared")
                 for name, text in sources.items() if text}
        built = {name: f.result() for name, f in built.items()}
    base = (sw_cuda.bind_band_library(built["baseline_band_build"]),
            {part: sw_cuda.bind_band_library(built[name])
             if name in built else None
             for part, name in (("dp", "baseline_chain_dp_probe"),
                                ("lookups", "baseline_lookups_probe"))})
    n_instr, n, hist = max(sass_loops(
        built["baseline_band_build"], CHAIN_KERNEL_SYMBOL, CHAIN_OPCODE),
        key=lambda t: (t[1], -t[0]))
    log(f"baseline {baseline}: its chain DP step issues "
        f"{n_instr / n * 32 / 64:.4f} SASS instructions per candidate ("
        + _describe(n_instr, n, hist) + ")")
    routes = re.search(r"band_index_build\([^)]*int route", src) is not None
    if not routes:  # a build whose index has its merge passes only
        base[0].band_index_build.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int] + \
            [ctypes.c_void_p] * 6
    base_dp = ctypes.CDLL(built["baseline_sw_banded"])
    base_dp.sw_banded_launch.restype = ctypes.c_int
    base_dp.sw_banded_launch.argtypes = (
        sw_cuda._banded_kernel().sw_banded_launch.argtypes)
    new = (sw_cuda._band_kernel(),
           {"dp": sw_cuda.bind_band_library(probes[0]),
            "lookups": sw_cuda.bind_band_library(probes[1])})
    x, haps, ir, ia = make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224))
    args = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    xr = args[0].repeat_interleave(2, dim=0)
    yr = args[1][torch.stack([args[2], args[3]], 1).reshape(-1).long()]
    ident = torch.arange(len(xr), dtype=torch.int32, device="cuda")
    modes = {"pair": (args, sw_cuda.band_index(args[1])),
             "rows": ((xr, yr, ident, None), sw_cuda.band_index(yr))}
    out = {}
    for mode, (a, index) in modes.items():
        expect = sw_cuda.band_bounds(*a, index)
        splits = collections.defaultdict(list)
        for who in ("baseline", "this", "this", "baseline"):
            lib, probe = base if who == "baseline" else new
            splits[who].append(band_split(lib, probe, a, index,
                                          sw_cuda.band_route(MAIN_LX),
                                          expect))
        for who in ("baseline", "this"):
            split = {k: (None if splits[who][0][k] is None else
                         statistics.median(s[k] for s in splits[who]))
                     for k in splits[who][0]}
            log_split(f"band_build {mode} ({who})", split, split["total"])
            out[(mode, who)] = split
        log(f"band_build {mode}: this checkout "
            f"{out[(mode, 'this')]['total']:.4f} ms against the baseline's "
            f"{out[(mode, 'baseline')]['total']:.4f} ms in turns ("
            + ", ".join(f"{s['total']:.4f}" for who in ("baseline", "this")
                        for s in splits[who]) + "), bounds equal")
        dp_args = tuple(a) + tuple(expect)
        per_read = 2 if mode == "pair" else 1
        route = sw_cuda.PAIR_ROUTES.index(sw_cuda.banded_route(MAIN_LX,
                                                              MAIN_LY))
        run = {"baseline": lambda: banded_ab_launch(
                   base_dp, dp_args, per_read, mode == "pair", 0),
               "this": lambda: banded_ab_launch(
                   sw_cuda._banded_kernel(), dp_args, per_read,
                   mode == "pair", route)}
        if not torch.equal(run["baseline"](), run["this"]()):
            fail(f"sw_banded's output differs from the baseline's ({mode})")
        times = collections.defaultdict(list)
        for who in ("baseline", "this", "this", "baseline"):
            times[who].append(time_cuda(run[who], 3, 15))
        dp = {who: statistics.median(t) for who, t in times.items()}
        out[(mode, "sw_banded")] = dp
        log(f"sw_banded {mode}: this checkout {dp['this']:.4f} ms against "
            f"the baseline's {dp['baseline']:.4f} ms in turns ("
            + ", ".join(f"{t:.4f}" for who in ("baseline", "this")
                        for t in times[who]) + "), outputs equal")
    out["band_index"] = index_ab(base[0], routes, [args[1]] + buckets,
                                 launch_floor(probes[3]))
    return out


def band_main(baseline=None):
    """The banded kernels alone (`python3 chip_smoke.py --band [--baseline
    DIR]`): phases 1 and 2, the SASS counts, phase 3's banded families,
    phase 4's banded timing with band_build's and sw_banded's splits and,
    given a baseline checkout, band_ab against it."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    card, clock_hz = phase_card()
    paths = phase_build()
    sass = phase_sass(paths)
    threads = os.cpu_count() or 1
    rng = np.random.default_rng(2024)
    work = os.path.join(HERE, "build", "chip_smoke_band")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            e2e_data = pool.submit(generate_e2e, work)
            phase_banded_equality(rng, threads)
            log(f"banded equality done at "
                f"{time.perf_counter() - t_start:.1f}s")
            phase_banded_timing(rng, sass, clock_hz, threads, paths[6:10])
            banded_split(rng)
            index_split(rng)
            data, _ = e2e_data.result()
        if baseline:
            band_ab(baseline, rng, paths[6:10], e2e_index_mats(work, data))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(card)


def e2e_index_mats(work, data):
    """The haplotype matrices band_index is given in phase 5's banded
    consensus run with --backend cuda (one per shape bucket), from one
    such run here (recording_index)."""
    from vartrix_tpu_torch import driver

    out = os.path.join(work, "banded_consensus.mtx")
    with recording_index() as rec:
        driver._main(["-v", data["vcf"], "-b", data["bam"], "-f",
                      data["fasta"], "-c", data["barcodes"], "-o", out,
                      "--sw-mode", "banded", "-s", "consensus", "--backend",
                      "cuda", "--threads", str(os.cpu_count() or 1)])
    log(f"e2e banded consensus: band_index given "
        + ", ".join(f"[{m.shape[0]}, {m.shape[1]}]" for m in rec.mats))
    return rec.mats


def main():
    if not os.path.exists(os.path.join(HERE, "vartrix_tpu_torch",
                                       "__init__.py")):
        fail("run from a checkout of the repository: vartrix_tpu_torch/ "
             "is missing")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    card, clock_hz = phase_card()
    paths = phase_build()
    sass = phase_sass(paths)
    threads = os.cpu_count() or 1
    rng = np.random.default_rng(2024)

    def done(phase):
        log(f"{phase} done at {time.perf_counter() - t_start:.1f}s")

    done("build")
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        # workers: phase 5's dataset, phase 6's, phase 7's Python host
        # dataset; then phase 5's BAM written as a CRAM and with N bases
        # beside phases 4-6
        with ProcessPoolExecutor(
                4, mp_context=multiprocessing.get_context("spawn")) as pool:
            e2e_data = pool.submit(generate_e2e, work)
            sparse_data = pool.submit(generate_sparse, work)
            py_data = pool.submit(generate_py_host, work)
            finish_wide = start_wide_pair(rng)
            worst = phase_equality(rng)
            done("sw_pair equality")
            (band_worst, banded_worst, index_worst, rows_band_worst,
             rows_worst) = phase_banded_equality(rng, threads)
            worst = max(worst, finish_wide())
            done("banded equality")
            log(f"phase 3: {AFTER_CALLS} kernel calls, each followed by a "
                "synchronisation of the default stream (no fault)")
            data, gen_s = e2e_data.result()
            log(f"e2e: generated {data['n_reads']} reads in {gen_s:.1f}s (in "
                "a worker process, during phase 3)")
            e2e_cram = pool.submit(write_cram_of, data)
            n_data = pool.submit(generate_n_reads, data)
            timing = phase_timing(rng, sass, clock_hz, paths[5])
            (band_timing, banded_timing, index_timing, band_rows_timing,
             banded_rows_timing) = phase_banded_timing(rng, sass, clock_hz,
                                                       threads, paths[6:10])
            done("timing")
            t0 = time.perf_counter()
            sparse, sparse_s = sparse_data.result()
            log(f"sparse: generated {sparse['n_reads']} reads in "
                f"{sparse_s:.1f}s (in a second worker process, from phase 3; "
                f"waited {time.perf_counter() - t0:.1f}s after phase 4)")
            launches, outs, run_launches, index_mats = phase_e2e(work, data)
            done("e2e")
            index_timing["buckets"] = time_buckets(index_mats, paths[9])
            t0 = time.perf_counter()
            n_reads, n_changed, n_s = n_data.result()
            log(f"n-reads: {n_changed} of phase 5's {data['n_reads']} reads "
                f"given one N in {n_s:.1f}s (a worker process, from phase "
                f"4; waited {time.perf_counter() - t0:.1f}s)")
            n_launches, n_routes, n_haps, n_shares = phase_n_reads(work,
                                                                   n_reads)
            done("n-reads")
            phase_cli(work)
            phase_sparse(work, sparse)
            done("sparse")
            t0 = time.perf_counter()
            data["cram"], cram_s = e2e_cram.result()
            py, py_s = py_data.result()
            log(f"cram/python: phase 5's {data['n_reads']} reads written as a "
                f"CRAM in {cram_s:.1f}s (a worker process, beside phases 4-6;"
                f" waited {time.perf_counter() - t0:.1f}s after phase 6); the "
                f"Python host dataset ({py['n_reads']} reads, BAM and CRAM) "
                f"in {py_s:.1f}s (a third worker process, from phase 3)")
        launches.update(phase_cram_python(work, data, py, outs, run_launches))
        done("cram and python host")
        device_launches = phase_devices(work, data, outs)
        done("device-agg, mesh and distributed")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sw_note = "no PyTorch call computes Smith-Waterman"
    kernels = [
        ("sw_pair", "vartrix_tpu_torch/csrc/sw_pair.cu",
         "vartrix_tpu/ops/sw_pallas_v2.py:55 (K1), :795 (K2), :1325 (K3), "
         ":1645 (K5); vartrix_tpu/ops/sw_pallas.py:52 (K6)",
         worst, timing, sw_note),
        ("sw_banded", "vartrix_tpu_torch/csrc/sw_banded.cu",
         "vartrix_tpu/ops/sw_pallas_v2.py:1836 (K4)",
         banded_worst, banded_timing, sw_note),
        ("band_build", "vartrix_tpu_torch/csrc/band_build.cu",
         "vartrix_tpu/ops/sw_pallas_v2.py:1945 (no TPU kernel: the host band "
         "construction of make_banded_tpu_scorer)",
         band_worst, band_timing, "no PyTorch call builds a chained band"),
        ("band_index", "vartrix_tpu_torch/csrc/band_build.cu",
         "vartrix_tpu/ops/sw_pallas_v2.py:1945 (no TPU kernel: the k-mer "
         "lookup of the host band construction of make_banded_tpu_scorer)",
         index_worst, index_timing, "torch.sort of the same keys"),
        ("sw_banded_rows", "vartrix_tpu_torch/csrc/sw_banded.cu",
         "vartrix_tpu/ops/sw_pallas_v2.py:1836 (K4, its plain-row entry "
         "_sw_banded_pairs, l.1908)",
         rows_worst, banded_rows_timing, sw_note),
        ("band_build_rows", "vartrix_tpu_torch/csrc/band_build.cu",
         "vartrix_tpu/ops/sw_pallas_v2.py:1945 (no TPU kernel: the host band "
         "construction of make_banded_tpu_scorer, on plain rows)",
         rows_band_worst, band_rows_timing,
         "no PyTorch call builds a chained band"),
    ]
    record = {"kernels": []}
    for name, source, replaces, err, t, note in kernels:
        n = launches[name]
        log(f"{name}: {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library_ms "
            f"{t['library_ms']} ({note}), {n} launches on its path"
            + (f"; the 32-bit scalar route {t['scalar_ms']:.4f} ms"
               if "scalar_ms" in t else ""))
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_note": note,
        })
        if "scalar_ms" in t:
            record["kernels"][-1]["word32_route_ms"] = t["scalar_ms"]
        if "split" in t:  # band_build: its steps (band_split), mappings
            record["kernels"][-1].update(split_ms=t["split"],
                                         mapping_ms=t["mapping_ms"])
        if name == "band_index":  # the kernel alone, the launch floor
            record["kernels"][-1].update(
                {k: t[k] for k in ("kernel_ms", "graph_ms", "launch_floor_ms",
                                   "launch_floor_back_to_back_ms",
                                   "wrapper_share_of_bound", "route_ms",
                                   "buckets")})
        if "share_of_bound" in t:
            record["kernels"][-1]["share_of_bound"] = t["share_of_bound"]
            if t["share_of_bound"] is None:
                record["kernels"][-1]["share_of_bound_note"] = t[
                    "share_note"]
        if name == "sw_pair":  # its read formats; the N dataset's routes
            record["kernels"][-1].update(
                {k: t[k] for k in ("packed4_ms", "packed2_ms", "dense_ms",
                                   "packed4_bound_ms", "hap_unpack_ms")},
                n_reads_launches=n_launches, read_route_chunks=n_routes,
                hap_route_buckets=n_haps, n_reads_idle_share=n_shares)
        if name == "sw_pair":  # its plain-row route on the Python host
            record["kernels"][-1]["python_host_launches"] = {
                k: v for k, v in launches.items() if k.startswith("sw_pair_")}
            record["kernels"][-1]["phase8_launches"] = device_launches
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def sanitizer_path():
    """compute-sanitizer of the CUDA toolkit (PATH, else CUDA_HOME/bin), or
    None."""
    for cand in (shutil.which("compute-sanitizer"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "compute-sanitizer")):
        if cand and os.path.exists(cand):
            return cand
    return None


def sanitizer_report(text):
    """A compute-sanitizer run of sanitize_child, read from its output:
    (the ERROR SUMMARY's count, or None where it printed none; per
    after() marker, in order, [kernel, family, route, the reports printed
    since the marker before]; reports after the last marker; the report
    blocks, each its header line and the lines that follow it)."""
    summary, calls, blocks, n = None, [], [], 0
    quiet = ("COMPUTE-SANITIZER", "ERROR SUMMARY", "RACECHECK SUMMARY",
             "LEAK SUMMARY", "Target application")
    for line in text.splitlines():
        m = re.match(r"========= ERROR SUMMARY: (\d+) error", line)
        if m:
            summary = int(m.group(1))
        if line.startswith(SANITIZE_MARK + "\t"):
            calls.append(line.split("\t")[1:4] + [n])
            n = 0
        elif (line.startswith("========= ") and line[10:11] not in ("", " ")
              and not line[10:].startswith(quiet)):
            n += 1
            blocks.append([line])
        elif line.startswith("=========  ") and blocks:
            blocks[-1].append(line)
    return summary, calls, n, blocks


def sanitize_child():
    """Phase 3's exactness checks (phase_equality, phase_banded_equality
    with its check_index families, check_long_hap, check_banded_limit and
    check_wide_banded), at the cut sizes SANITIZE sets, for sanitize_main
    under compute-sanitizer; after() marks each kernel call."""
    import numpy as np

    sys.path.insert(0, HERE)
    rng = np.random.default_rng(2024)
    phase_equality(rng)
    phase_banded_equality(rng, os.cpu_count() or 1)
    log("sanitize child: every check passed")


def sanitize_main():
    """`python3 chip_smoke.py --sanitize`: sanitize_child under each tool of
    SANITIZE_TOOLS (compute-sanitizer, the CUDA toolkit's), in a process of
    its own each, all at once, with PyTorch's caching allocator off (every
    tensor its own allocation, so memcheck sees each bound); only this
    repository's kernels instrumented. Every tool's error count is read;
    a count above 0, a child that fails or a tool that is missing fails
    the mode, naming the kernel, family and route of each report."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    tool_path = sanitizer_path()
    if tool_path is None:
        fail("compute-sanitizer is missing (neither on PATH nor in "
             "CUDA_HOME/bin): --sanitize cannot run")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    card, _ = phase_card()
    phase_build()  # every library, before any tool runs
    version = subprocess.run([tool_path, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
    out_dir = os.path.join(HERE, "build", "chip_smoke_sanitize")
    os.makedirs(out_dir, exist_ok=True)
    # a tool that cannot check this device fails every program it runs
    probe = subprocess.run(
        [tool_path, "--tool", "memcheck", sys.executable, "-c",
         "import torch; torch.ones(1, device='cuda').sum().item()"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    refused = [ln for ln in probe.stdout.splitlines()
               if "not supported" in ln]
    if refused:
        fail(f"--sanitize: {tool_path} ({version[-1] if version else '?'}) "
             f"does not support this device, so no tool ran: "
             f"{refused[0].strip()}")
    log(f"sanitize: {tool_path}, {version[-1] if version else '?'}; cuts: "
        f"main family 4,096 reads (not 65,536), the 100 kb locus "
        f"{LONG_HAP_READS} reads (not 512), the homopolymer locus "
        f"{HOMOPOLYMER_READS} reads (not 128) under a 64 MiB chain-pass "
        "budget, sw_pair's packed_limit and near_limit families and the "
        "wide sw_pair launches left out (1 G cells and more a problem; "
        "sw_pair runs every route on every other family)")

    def run(tool):
        argv = [tool_path, "--tool", tool, "--report-api-errors", "no",
                "--print-limit", "50", *SANITIZE_FILTER,
                sys.executable, os.path.abspath(__file__),
                "--sanitize-child"]
        env = dict(os.environ, CHIP_SMOKE_SANITIZE=tool,
                   PYTORCH_NO_CUDA_MEMORY_CACHING="1")
        t0 = time.perf_counter()
        proc = subprocess.run(argv, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=HERE)
        with open(os.path.join(out_dir, f"{tool}.log"), "w") as f:
            f.write(" ".join(argv) + "\n" + proc.stdout)
        return proc.returncode, proc.stdout, time.perf_counter() - t0

    with ThreadPoolExecutor(len(SANITIZE_TOOLS)) as ex:
        runs = dict(zip(SANITIZE_TOOLS, ex.map(run, SANITIZE_TOOLS)))
    bad = []
    for tool, (rc, text, dt) in runs.items():
        summary, calls, tail, blocks = sanitizer_report(text)
        kernels = collections.Counter(c[0] for c in calls)
        log(f"sanitize {tool}: exit {rc}, ERROR SUMMARY {summary}, "
            f"{sum(c[3] for c in calls) + tail} reports over {len(calls)} "
            f"checked kernel calls ({dict(kernels)}) on "
            f"{len({c[1] for c in calls})} families; {dt:.1f} s")
        for kernel, family, route, n in calls:
            log(f"sanitize {tool}\t{kernel}\t{family}\t{route}\t{n}")
        if tail:
            log(f"sanitize {tool}: {tail} reports after the last check")
        for block in blocks[:20]:
            log("\n".join(block[:8]))
        if rc != 0 or summary is None or summary or tail or blocks:
            bad.append(tool)
            log("\n".join(text.splitlines()[-40:]))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(card)
    if bad:
        fail("--sanitize: " + ", ".join(bad) + " reported errors or failed "
             f"(full output in {out_dir})")
    print(json.dumps({"sanitize": {t: 0 for t in runs}}))


if __name__ == "__main__":
    if "--sanitize-child" in sys.argv[1:]:
        sanitize_child()
    elif "--sanitize" in sys.argv[1:]:
        sanitize_main()
    elif "--band" in sys.argv[1:]:
        if not os.path.exists(os.path.join(HERE, "vartrix_tpu_torch",
                                           "__init__.py")):
            fail("run from a checkout of the repository: vartrix_tpu_torch/ "
                 "is missing")
        argv = sys.argv[1:]
        band_main(argv[argv.index("--baseline") + 1]
                  if "--baseline" in argv else None)
    else:
        main()
