#!/usr/bin/env python3
"""GPU smoke check of vartrix_tpu_torch, the PyTorch/CUDA package.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. card and toolchain: name and power limit (nvidia-smi), torch, CUDA;
  2. build: the CUDA kernels sw_pair.cu, sw_banded.cu and band_build.cu
     (nvcc), libgenomio and the host band reference band_bounds.cpp (g++)
     from the checkout's sources, two probes (nvcc, SASS only: the least
     DP cell update, and band_build's candidate scoring) and a DPX rate
     probe (nvcc), all in parallel, with the compiler's register report;
  3. each kernel against its plain PyTorch version on the card, exact
     equality. sw_pair (int32 scores and int8 codes) on each of its three
     routes: dense and 2-bit reads over the shape families of the full
     path, the interleaved-index and plain-row entries (the TPU kernels K5
     and K6); reads at min(lx, ly) = 32,767 that score 32,767, the packed
     route's edge; one read long enough to take the 32-bit scratch word
     near its 16-bit halves' limit; and reads of 65,602 bases against a
     70,000-base haplotype, scored above that limit by the 64-bit word
     (two launches of one warp each, a minute or more, on streams of their
     own beside the rest of this phase; every other check waits on the
     default stream only). band_index: the k-mer
     index of every banded family's haplotypes against its plain version.
     band_build: its int32
     bounds against the plain version and the host reference on the
     families of the banded path (main, bending bands, full bands, empty
     bands, empty haplotypes, raw bytes, ly=4032, a haplotype wider than
     32,767 bases, low-complexity pairs with thousands of matches), with
     32- and 64-bit chain keys, and against the host reference on one
     homopolymer locus at ly=4032 whose matches need several chain-pass
     ranges and on the 65,602-base reads. sw_banded: scores and codes on
     those bounds against its plain version. A 100,000-base haplotype pair
     (a deletion alt) against 2,048 reads, under scratch budgets small
     enough that band_build, sw_banded and sw_pair each run several
     ranges, against the plain versions and the host reference;
  4. timing at the main bucket shape (lx=160, ly=224, 131,072 pairs) with
     CUDA events: each kernel, its plain version, and its bound at the
     card's instruction issue rate against its bytes. The DP kernels'
     bound charges each needed cell the least cell update, read from the
     SASS of a probe that includes neither kernel (cuobjdump); beside it
     the SASS of each hot loop and the DPX add-max rate of the card. For
     sw_pair both its packed and its 32-bit scalar route, in turns; for
     sw_banded the instructions per cell of its
     core and of its masked zones, the cells it visits and the lane slots
     its divergence leaves idle; for band_build (given its index) the host
     reference's time per pair (the route it replaced); band_index on the
     bucket's haplotype matrix, and torch.sort of the same keys;
  5. end to end: a seeded 500,000-read dataset (generated in a worker
     process while phase 3 runs) through the driver in
     --sw-mode full and banded, each with --backend cuda in the three
     scoring modes, each repeated with --backend torch; matrices must agree,
     each mode's kernels must have launched on its cuda runs and never on
     the torch runs, the other mode's never, the index once per shape
     bucket, and the host band reference never. The CLI entry (python -m
     vartrix_tpu_torch) runs on a small dataset in both modes.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

import collections
import json
import math
import multiprocessing
import os
import re
import shutil
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
# route); banded, int8 call codes (32-bit scratch words; 32-bit chain keys)
MAIN_KERNEL_SYMBOL = "sw_pair16x2_kernelILb1ELb1E"
SCALAR_KERNEL_SYMBOL = "sw_pair_kernelILb1ELb1ELb0E"
BANDED_KERNEL_SYMBOL = "sw_banded_kernelILb1ELb0EE"
CHAIN_KERNEL_SYMBOL = "chain_kernelIiE"
# the SASS instruction that marks one DP cell in each kernel's hot loop:
# on the packed route one per two problems' cell, the add-max with zero
# (T); on the scalar routes and in sw_banded the three-way H maximum with
# zero; and one chain DP step (64 candidate predecessors) in band_build's:
# the warp-wide maximum
PACKED_CELL_OPCODE = "VIADDMNMX.S16x2.RELU"
CELL_OPCODE = "VIMNMX3.RELU"
CHAIN_OPCODE = "REDUX"
# the DPX opcodes (add-max and three-way max) among a loop's instructions
DPX_OPCODES = ("VIADDMNMX", "VIMNMX3")
STRIP = 8  # read rows per strip of sw_banded.cu (kStrip)
# band_build's bound charges each chain candidate the instructions of its
# scoring alone (band_build.cu `candidate`) and one max: the SASS of a loop
# that does that per candidate less that of the same loop without it (its
# LOP3s, which only consume the loads, not counted), both loading the
# candidate's slot. A key lookup is charged a source count:
# the key's rolling update (shift, or, mask) and one probe of a hashed
# index of the haplotype's keys (hash, load, compare, branch).
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
MAIN_LX, MAIN_LY, MAIN_READS = 160, 224, 65536
E2E_CFG = dict(n_chroms=4, chrom_len=200_000, n_variants=1000, n_cells=2000,
               reads_per_variant=500, spliced_frac=0.5, seed=100)


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


def long_hap_family(rng, n_reads=2048, lx=160, ly=100_000):
    """2,048 reads of 140-150 bases (1 % errors) sampled from a
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


def strip_stats(x, jlo, jhi, ly):
    """What sw_banded.cu does with its strips of STRIP rows on these
    bounds (its zone rule, in numpy): (visited cells, core cells, share of lane
    slots its warps leave idle). A strip visits [c0, c1), the union of its
    in-band rows; its core is [max jlo, min jhi) over its rows below the
    read's true length, clipped to [c0, c1); a warp runs each of a strip's
    three zones (entry, core, exit) as long as its widest lane."""
    import numpy as np

    lx, P = jlo.shape
    strip = STRIP
    n = -(-lx // strip) * strip
    nz = x != 0
    len_x = np.where(nz.any(1), lx - np.argmax(nz[:, ::-1], axis=1), 0)
    len_x = np.repeat(len_x, 2)
    lo = np.zeros((n, P), np.int64)
    hi = np.zeros((n, P), np.int64)
    lo[:lx], hi[:lx] = jlo, jhi
    band = lo < hi
    under = np.arange(n)[:, None] < len_x[None, :]
    big = np.iinfo(np.int64).max

    def per_strip(a, reduce):
        return reduce(a.reshape(-1, strip, P), axis=1)

    c0 = np.maximum(per_strip(np.where(band, lo, big), np.min), 0)
    c1 = np.minimum(per_strip(np.where(band, hi, 0), np.max), ly)
    cols = np.maximum(c1 - c0, 0)
    core_lo = per_strip(np.where(under, lo, 0), np.max)
    core_hi = per_strip(np.where(under, hi, ly), np.min)
    a = np.maximum(c0, np.minimum(core_lo, c1))
    b = np.maximum(a, np.minimum(core_hi, c1))
    live = cols > 0
    core = np.where(live, b - a, 0)
    warp_cols = sum(
        np.where(live, z, 0).reshape(cols.shape[0], -1, 32).max(axis=2).sum()
        for z in (a - c0, b - a, c1 - b))
    return (strip * int(cols.sum()), strip * int(core.sum()),
            1 - cols.sum() / (32 * warp_cols))


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
    two probes' and the DPX rate probe's."""
    from vartrix_tpu_torch.ops import _build

    t0 = time.perf_counter()
    builders = (_build.kernel_library, _build.banded_kernel_library,
                _build.band_build_library, _build.genomio_library,
                _build.band_bounds_library,
                lambda: build_probe("candidate_probe", PROBE_SRC),
                lambda: build_probe("cell_probe", CELL_PROBE_SRC),
                lambda: build_probe("dpx_rate", DPX_RATE_SRC, "-shared"))
    with ThreadPoolExecutor(max_workers=len(builders)) as ex:
        futures = [ex.submit(b) for b in builders]
        paths = [f.result() for f in futures]
    log(f"build: sw_pair.cu + sw_banded.cu + band_build.cu + genomio.cpp + "
        f"band_bounds.cpp + the candidate, cell and DPX rate probes in "
        f"{time.perf_counter() - t0:.2f}s")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"  nvcc: {nvcc[-1]}")
    for path in paths[:3]:
        for line in _build.build_log(path).splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  ptxas {os.path.basename(path)}: {line.strip()}")
    return paths[:3] + paths[5:]


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
    kern, banded, band, probe, cell_probe, _ = paths
    n_instr, n, hist = max(sass_loops(kern, MAIN_KERNEL_SYMBOL,
                                      PACKED_CELL_OPCODE),
                           key=lambda t: t[1])
    log(f"sass: {MAIN_KERNEL_SYMBOL} hot loop, per two problems' cell: "
        + _describe(n_instr, n, hist))
    packed = n_instr / (2 * n)
    packed_dpx = dpx_count(hist) / (2 * n)
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
    cell_dpx = steps["_Z10cell_probe"][1] / 4
    if cell <= 0:
        fail("the cell probe's loop is no longer than its load probe's")
    log(f"sass: the least cell update {cell:.4f} instructions per problem "
        f"cell ({cell_dpx:.4f} of them DPX); sw_pair's packed loop issues "
        f"{packed:.4f} ({packed_dpx:.4f} DPX), its scalar loop {scalar:.4f}")
    loops = sorted(sass_loops(banded, BANDED_KERNEL_SYMBOL, CELL_OPCODE),
                   key=lambda t: t[0] / t[1])
    for name, loop in (("core", loops[0]), ("masked", loops[-1])):
        log(f"sass: {BANDED_KERNEL_SYMBOL} {name} loop, per cell: "
            + _describe(*loop))
    zones = (loops[0][0] / loops[0][1], loops[-1][0] / loops[-1][1])
    probe_loops = {}
    for sym in ("_Z15candidate_probe", "_Z10load_probe"):
        loop = min(sass_loops(probe, sym, "LDG"), key=lambda t: t[0])
        lop3 = loop[2]["LOP3.LUT"] if sym == "_Z10load_probe" else 0
        probe_loops[sym] = loop[0] - lop3
        log(f"sass: {sym} loop, per iteration: " + _describe(loop[0], 1,
                                                             loop[2])
            + (f"; {lop3} LOP3 not counted" if lop3 else ""))
    per_candidate = (probe_loops["_Z15candidate_probe"]
                     - probe_loops["_Z10load_probe"])
    if per_candidate <= 0:
        fail("the candidate probe's loop is no longer than the load probe's")
    n_instr, n, hist = min(sass_loops(band, CHAIN_KERNEL_SYMBOL,
                                      CHAIN_OPCODE), key=lambda t: t[0])
    log(f"sass: {CHAIN_KERNEL_SYMBOL} DP step, per {CHAIN_OPCODE}: "
        + _describe(n_instr, n, hist))
    log(f"sass: a chain candidate's own work {per_candidate} instructions "
        f"(scoring and one max); band_build's DP step issues "
        f"{n_instr / n * 32 / 64:.4f} per candidate (64 per warp step)")
    return dict(cell=cell, cell_dpx=cell_dpx, packed=packed,
                packed_dpx=packed_dpx, scalar=scalar, zones=zones,
                per_candidate=per_candidate)


def phase_equality(rng):
    """sw_pair against its plain version on every family and route;
    returns max |err|."""
    import numpy as np
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
    }
    worst = 0
    for name, (x, haps, ir, ia) in families.items():
        xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
        plain = sw_torch.pair_scores(xt, ht, irt, iat)
        plain_codes = sw_torch.calls_from_scores(plain)
        forms = [("dense", xt, None)]
        if np.isin(x[x != 0], np.frombuffer(b"ACGT", np.uint8)).all():
            xp, lens = pack2(x)
            forms.append(("2bit", torch.from_numpy(xp).cuda(),
                          torch.from_numpy(lens).cuda()))
        for form, reads, lens in forms:
            res = []
            for route in sw_cuda.PAIR_ROUTES:
                got = sw_cuda.pair_scores(reads, ht, irt, iat,
                                          read_lens=lens, route=route)
                codes = sw_cuda.pair_calls(reads, ht, irt, iat,
                                           read_lens=lens, route=route)
                sync()
                err = int((got - plain).abs().max().item()) if len(x) else 0
                bad = int((codes != plain_codes).sum().item())
                worst = max(worst, err)
                res.append(f"{route} max|err|={err} code mismatches={bad}")
                if err or bad:
                    fail(f"kernel disagrees with the plain version on {name} "
                         f"({form}, {route})")
            by_width = sw_cuda.pair_route(x.shape[1], haps.shape[1])
            log(f"sw_pair {name:11s} {form:5s} R={len(x)} lx={x.shape[1]} "
                f"ly={haps.shape[1]} ({by_width} by width): "
                + "; ".join(res))
        if name == "ly_4032":
            wide = (x, haps, ir, ia)
    # the packed route's edge, then near the 32-bit scratch word's limit:
    # against the plain version and the known scores
    for fam, route in ((packed_limit_family, "packed"),
                       (near_limit_family, "word32")):
        x, haps, ir, ia, known = fam(rng)
        if sw_cuda.pair_route(x.shape[1], haps.shape[1]) != route:
            fail(f"{fam.__name__} does not take the {route} route")
        xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
        t0 = time.perf_counter()
        got = sw_cuda.pair_scores(xt, ht, irt, iat)
        codes = None
        if route == "packed":
            xp, lens = pack2(x)
            codes = sw_cuda.pair_calls(torch.from_numpy(xp).cuda(), ht, irt,
                                       iat, read_lens=torch.from_numpy(
                                           lens).cuda())
        sync()
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
    n0 = sw_cuda.LAUNCHES
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
    n = sw_cuda.LAUNCHES - n0

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


def check_index(name, ht):
    """band_index on the card against its plain version: (the index,
    entries that differ)."""
    import torch

    from vartrix_tpu_torch.ops import band_torch, sw_cuda

    got = sw_cuda.band_index(ht)
    exp = band_torch.band_index(ht)
    n = (exp.hap_len.long() - 5).clamp_min(0)
    valid = torch.arange(ht.shape[1], device=ht.device)[None, :] < n[:, None]
    bad = (int((got.hap_len != exp.hap_len).sum().item())
           + int((got.keys != exp.keys)[valid].sum().item())
           + int((got.pos != exp.pos)[valid].sum().item()))
    log(f"band_index {name:11s} H={ht.shape[0]} ly={ht.shape[1]}: "
        f"{int(n.sum().item())} keys, mismatches vs plain {bad}")
    if bad:
        fail(f"band_index disagrees with the plain version on {name}")
    return got, bad


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
    }
    worst = band_worst = index_worst = 0
    for name, (x, haps, ir, ia) in families.items():
        host = sw_native.band_bounds(x, haps, ir, ia, threads)
        xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
        index, bad = check_index(name, ht)
        index_worst = max(index_worst, bad)
        got = sw_cuda.band_bounds(xt, ht, irt, iat, index)
        plain = band_torch.band_bounds(xt, ht, irt, iat)
        sync()
        bad = sum(int((g.cpu().numpy() != h).sum()) + int((g != q).sum().item())
                  for g, h, q in zip(got, host, plain))
        if name in ("main", "repetitive"):  # the 64-bit chain keys
            saved, sw_cuda.BAND_WIDE_KEYS_LX = sw_cuda.BAND_WIDE_KEYS_LX, 0
            try:
                wide = sw_cuda.band_bounds(xt, ht, irt, iat, index)
            finally:
                sw_cuda.BAND_WIDE_KEYS_LX = saved
            nw = sum(int((w != g).sum().item()) for w, g in zip(wide, got))
            log(f"band_build {name:11s} 64-bit chain keys: mismatches vs "
                f"32-bit {nw}")
            bad += nw
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
    # one homopolymer locus: its chain pass runs over several ranges of the
    # scratch budget. The plain builder's loop over match ranks would take
    # minutes here, so the bounds are held against the host reference
    # only; sw_banded against its plain version as above.
    x, haps, ir, ia = homopolymer_locus(rng)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    matches = match_counts(xt, ht, irt, iat)
    ranges = sw_cuda.band_ranges(torch.cumsum(matches, 0).cpu().numpy(),
                                 x.shape[1], sw_cuda.BAND_SCRATCH_BYTES)
    t0 = time.perf_counter()
    got = sw_cuda.band_bounds(xt, ht, irt, iat)
    sync()
    dt = time.perf_counter() - t0
    host = sw_native.band_bounds(x, haps, ir, ia, threads)
    bad = sum(int((g.cpu().numpy() != h).sum()) for g, h in zip(got, host))
    log(f"band_build homopolymer R={len(x)} lx={x.shape[1]} "
        f"ly={haps.shape[1]}: bound mismatches vs host {bad}; matches "
        f"{int(matches.sum())} ({int(matches.max())} per problem at most, "
        f"{12 * int(matches.sum()) / 2**30:.2f} GiB of match scratch), "
        f"{len(ranges)} chain-pass ranges of at most "
        f"{sw_cuda.BAND_SCRATCH_BYTES / 2**30:.2f} GiB; {dt:.3f} s")
    if bad:
        fail("band_build disagrees with the host reference on the "
             "homopolymer locus")
    if len(ranges) < 2:
        fail("the homopolymer locus fits one chain-pass range")
    err, _ = check_banded("homopolymer", (xt, ht, irt, iat) + tuple(got))
    worst = max(worst, err)
    worst = max(worst, check_wide_banded(rng, threads))
    err, bad = check_long_hap(rng, threads)
    return max(band_worst, bad), max(worst, err), index_worst


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
    sync()
    dt = time.perf_counter() - t0
    host = sw_native.band_bounds(x, haps, ir, ia, threads)
    bad = sum(int((g.cpu().numpy() != h).sum()) for g, h in zip(got, host))
    log(f"band_build wide R={len(x)} lx={x.shape[1]} ly={haps.shape[1]} "
        f"({x.shape[1] * haps.shape[1]} cells per problem): bound "
        f"mismatches vs host {bad}; {dt:.3f} s")
    if bad:
        fail("band_build disagrees with the host reference on the wide "
             "family")
    n0 = sw_cuda.BANDED_LAUNCHES
    err, ref = check_banded("wide", (xt, ht, irt, iat) + tuple(got))
    if (ref.T.cpu() != torch.tensor(known)).any() or \
            sw_cuda.BANDED_LAUNCHES - n0 != 2:
        fail("sw_banded's 64-bit scratch word: not the known scores")
    return err


def check_long_hap(rng, threads):
    """long_hap_family under 64 MiB scratch budgets: band_index once,
    band_build (several chain-pass ranges) against the plain version and
    the host reference, sw_banded (scores and codes) and sw_pair (scores)
    over several read ranges against their plain versions. Returns (max
    |err| of the DP kernels, bound mismatches)."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import band_torch, sw_cuda, sw_native, sw_torch

    x, haps, ir, ia = long_hap_family(rng)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    saved = sw_cuda.DP_SCRATCH_BYTES, sw_cuda.BAND_SCRATCH_BYTES
    sw_cuda.DP_SCRATCH_BYTES = sw_cuda.BAND_SCRATCH_BYTES = 64 << 20
    try:
        n0 = (sw_cuda.LAUNCHES, sw_cuda.BANDED_LAUNCHES,
              sw_cuda.BAND_LAUNCHES)
        t0 = time.perf_counter()
        index, _ = check_index("long_hap", ht)
        got = sw_cuda.band_bounds(xt, ht, irt, iat, index)
        sync()
        dt = time.perf_counter() - t0
        n_band = sw_cuda.BAND_LAUNCHES - n0[2]
        args = (xt, ht, irt, iat) + tuple(got)
        err, _ = check_banded("long_hap", args)
        n_banded = (sw_cuda.BANDED_LAUNCHES - n0[1]) // 2
        pair = sw_cuda.pair_scores(xt, ht, irt, iat)
        sync()
        n_pair = sw_cuda.LAUNCHES - n0[0]
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


def check_banded(name, args):
    """sw_banded's scores and codes on `args` (reads, haplotypes, indices,
    bounds on the card) against its plain version; (max |err|, the plain
    scores)."""
    import torch

    from vartrix_tpu_torch.ops import sw_banded_torch, sw_cuda, sw_torch

    t0 = time.perf_counter()
    ref = sw_banded_torch.banded_pair_scores(*args)
    sync()
    dt = time.perf_counter() - t0
    sc = sw_cuda.banded_pair_scores(*args)
    codes = sw_cuda.banded_pair_calls(*args)
    sync()
    err = int((sc - ref).abs().max().item())
    bad = int((codes != sw_torch.calls_from_scores(ref)).sum().item())
    log(f"sw_banded {name:11s}: max|err|={err} code mismatches={bad}; max "
        f"score {int(ref.max().item())}; plain {dt:.1f} s")
    if err or bad:
        fail(f"sw_banded disagrees with the plain version on {name}")
    return err, ref


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
    SASS per cell, its registers and the extra cells its pairs compute."""
    import torch

    from vartrix_tpu_torch.ops import _build, sw_cuda, sw_torch

    x, haps, ir, ia = make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224))
    xp, lens = pack2(x)
    _, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    xpt = torch.from_numpy(xp).cuda()
    lt = torch.from_numpy(lens).cuda()
    times = collections.defaultdict(list)
    for route in ("word32", "packed", "packed", "word32"):
        times[route].append(time_cuda(lambda: sw_cuda.pair_calls(
            xpt, ht, irt, iat, read_lens=lt, route=route), 3, 15))
    ms, scalar_ms = (statistics.median(times[r]) for r in ("packed",
                                                           "word32"))
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
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None, scalar_ms=scalar_ms)


def phase_banded_timing(rng, sass, clock_hz, threads):
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
    pair, the route band_build replaced."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import (band_torch, sw_banded_torch, sw_cuda,
                                       sw_native)

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
    band_ms = time_cuda(lambda: sw_cuda.band_bounds(*args, index), 3, 15)
    band_plain_ms = time_cuda(lambda: band_torch.band_bounds(*args), 1, 2)
    jlo_t, jhi_t = sw_cuda.band_bounds(*args, index)
    jlo, jhi = jlo_t.cpu().numpy(), jhi_t.cpu().numpy()
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
        f"{b_bound:.4f} ms, {100 * b_bound / band_ms:.1f} % of the kernel's "
        "time; library_ms null: no PyTorch call builds a chained band")
    band = dict(ms=band_ms, plain_ms=band_plain_ms, bound_ms=b_bound,
                bound_by="operations" if b_ops_ms >= b_bytes_ms else "bytes",
                library_ms=None)
    index_timing = time_index(args[1], issue_per_s)
    # sw_banded on the kernel's bounds
    dp_args = args + (jlo_t, jhi_t)
    ms = time_cuda(lambda: sw_cuda.banded_pair_calls(*dp_args), 3, 15)
    plain_ms = time_cuda(lambda: sw_banded_torch.banded_pair_calls(
        *dp_args), 1, 3)
    in_band = int((jhi.astype(np.int64) - jlo).sum())
    full = true_cells(x, haps, ir, ia)
    ops_ms = in_band * pair_instr / issue_per_s * 1e3
    nbytes = (x.nbytes + haps.nbytes + ir.nbytes + ia.nbytes + jlo.nbytes
              + jhi.nbytes + MAIN_READS)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"timing sw_banded cells: {in_band} in band ({in_band / pairs:.1f} "
        f"per pair; full SW needs {full}, {100 * in_band / full:.1f} %)")
    log(f"timing sw_banded bound: {in_band} in-band cells x "
        f"{pair_instr:.4f} instructions per cell (the least cell update, "
        f"the cell probe's SASS) / {issue_per_s:.6g} instructions/s = "
        f"{ops_ms:.4f} ms (at sw_pair's scalar loop's {sass['scalar']:.4f} "
        f"per cell, the bound of PR 7 and before: "
        f"{in_band * sass['scalar'] / issue_per_s * 1e3:.4f} ms); "
        f"{nbytes} bytes / {HBM_BYTES_PER_S:.3g} B/s = {bytes_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms; library_ms null: no PyTorch call "
        "computes Smith-Waterman")
    visited, core, idle = strip_stats(x, jlo, jhi, MAIN_LY)
    core_i, masked_i = sass["zones"]
    issued = core * core_i + (visited - core) * masked_i
    issued_ms = issued / issue_per_s * 1e3
    log(f"timing sw_banded: {ms:.4f} ms ({in_band / ms / 1e6:.1f} G in-band "
        f"cells/s), bound {100 * bound_ms / ms:.1f} % of it; plain "
        f"{plain_ms:.3f} ms; visits {visited} cells "
        f"({100 * visited / in_band:.1f} % of in band), {core} in the core "
        f"({100 * core / visited:.1f} % of "
        f"visited) at {core_i:.4f} instructions per cell and {visited - core}"
        f" masked at {masked_i:.4f}; {issued / in_band:.4f} issued per "
        f"in-band cell, {issued_ms:.4f} ms at full issue "
        f"({100 * issued_ms / ms:.1f} % of its time); its warps leave "
        f"{100 * idle:.1f} % of lane slots idle")
    banded = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                  library_ms=None)
    return band, banded, index_timing


def time_index(ht, issue_per_s):
    """band_index on one bucket's haplotype matrix: kernel, plain version,
    and torch.sort of the same keys (the library call that sorts them;
    the port never calls it). Bound: the haplotype bytes read once and
    the index (12 bytes per key, 4 per row length) written once, against
    one placement per key and merge pass (n ceil(log2 n) per row) at the
    issue rate."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import band_torch, sw_cuda

    ms = time_cuda(lambda: sw_cuda.band_index(ht), 3, 15)
    plain_ms = time_cuda(lambda: band_torch.band_index(ht), 1, 3)
    hap_len = band_torch.true_lengths(ht, 1)
    keys = band_torch.kmer_keys(ht, hap_len, (1 << 63) - 1)
    library_ms = time_cuda(lambda: torch.sort(keys, dim=1, stable=True),
                           3, 15)
    n = np.maximum(hap_len.cpu().numpy() - 5, 0)
    passes = np.ceil(np.log2(np.maximum(n, 1)))
    ops_ms = float((n * passes).sum()) / issue_per_s * 1e3
    nbytes = ht.numel() + 12 * int(n.sum()) + 4 * ht.shape[0]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"timing band_index H={ht.shape[0]} ly={ht.shape[1]} "
        f"({int((n > 0).sum())} rows with keys, {int(n.sum())} keys): "
        f"{ms:.4f} ms; plain {plain_ms:.3f} ms; torch.sort of the keys "
        f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({nbytes} bytes / "
        f"{HBM_BYTES_PER_S:.3g} B/s = {bytes_ms:.4f} ms; "
        f"{int((n * passes).sum())} placements / {issue_per_s:.6g} "
        f"instructions/s = {ops_ms:.4f} ms), {100 * bound_ms / ms:.1f} % of "
        "the kernel's time")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=library_ms)


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


def generate_e2e(work):
    """Phase 5's dataset (run in a worker process during phase 3): (the
    dataset's paths and read count, seconds taken)."""
    from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

    t0 = time.perf_counter()
    data = generate_dataset(os.path.join(work, "e2e"), SynthConfig(**E2E_CFG))
    return data, time.perf_counter() - t0


def phase_e2e(work, data):
    """Both paths, full then banded, each in the three modes with --backend
    cuda and then torch, on generate_e2e's dataset. Every kernel's count is
    zeroed just before each (path, backend) group and read just after;
    returns the launches of the full path's cuda runs (sw_pair) and the
    banded path's (sw_banded, band_build, band_index). The host band
    reference must never be called."""
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
    for sw_mode in own:
        for be, be_args in backends.items():
            sw_cuda.LAUNCHES = sw_cuda.BANDED_LAUNCHES = 0
            sw_cuda.BAND_LAUNCHES = sw_cuda.INDEX_LAUNCHES = 0
            buckets[0] = 0
            for mode, mode_args in modes.items():
                tag = f"{sw_mode}_{mode}_{be}"
                out = os.path.join(work, f"{tag}.mtx")
                ref = os.path.join(work, f"{tag}_ref.mtx")
                mj = os.path.join(work, f"{tag}.json")
                argv = ["-v", data["vcf"], "-b", data["bam"], "-f",
                        data["fasta"], "-c", data["barcodes"], "-o", out,
                        "--ref-matrix", ref, "--sw-mode", sw_mode,
                        "--threads", str(os.cpu_count() or 1),
                        "--metrics-json", mj] + mode_args + be_args
                t0 = time.perf_counter()
                driver._main(argv)
                dt = time.perf_counter() - t0
                with open(mj) as f:
                    payload = json.load(f)
                shape = payload["matrix"]["shape"]
                if shape != [E2E_CFG["n_variants"], E2E_CFG["n_cells"]]:
                    fail(f"{tag}: matrix shape {shape}")
                log(f"e2e {tag}: {dt:.3f}s, {n_reads / dt:.0f} reads/s, nnz "
                    f"{payload['matrix']['nnz']}, launches "
                    f"{payload['kernel_launches']}, phases "
                    f"{payload['phase_seconds']}")
                outs[sw_mode, mode, be] = (out, ref)
            launches[sw_mode, be] = {"sw_pair": sw_cuda.LAUNCHES,
                                     "sw_banded": sw_cuda.BANDED_LAUNCHES,
                                     "band_build": sw_cuda.BAND_LAUNCHES,
                                     "band_index": sw_cuda.INDEX_LAUNCHES}
            n_buckets[sw_mode, be] = buckets[0]
            log(f"e2e {sw_mode} {be}: launches over the three runs "
                f"{launches[sw_mode, be]}; banded shape buckets "
                f"{buckets[0]}")
    for sw_mode, kernels in own.items():
        for be in backends:
            for name, n in launches[sw_mode, be].items():
                if (n > 0) != (be == "cuda" and name in kernels):
                    fail(f"--sw-mode {sw_mode} --backend {be}: {name} "
                         f"launched {n} times")
        for mode in modes:
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
    return {"sw_pair": launches["full", "cuda"]["sw_pair"],
            "sw_banded": launches["banded", "cuda"]["sw_banded"],
            "band_build": launches["banded", "cuda"]["band_build"],
            "band_index": launches["banded", "cuda"]["band_index"]}


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
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            e2e_data = pool.submit(generate_e2e, work)
            finish_wide = start_wide_pair(rng)
            worst = phase_equality(rng)
            done("sw_pair equality")
            band_worst, banded_worst, index_worst = phase_banded_equality(
                rng, threads)
            worst = max(worst, finish_wide())
            done("banded equality")
            data, gen_s = e2e_data.result()
        log(f"e2e: generated {data['n_reads']} reads in {gen_s:.1f}s (in a "
            "worker process, during phase 3)")
        timing = phase_timing(rng, sass, clock_hz, paths[-1])
        band_timing, banded_timing, index_timing = phase_banded_timing(
            rng, sass, clock_hz, threads)
        done("timing")
        launches = phase_e2e(work, data)
        done("e2e")
        phase_cli(work)
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
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
