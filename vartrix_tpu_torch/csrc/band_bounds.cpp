// Per-row band bounds of --sw-mode banded, built on the host: the port's
// exact host reference of the band, on no path of the program. Banded runs
// build the same bounds on the device (csrc/band_build.cu, plain version
// ops/band_torch.py); the tests and chip_smoke.py hold both against this
// file.
//
// The port's own copy of the chained-band construction of the JAX package's
// native aligner (native/swlib.cpp build_chained_band, the rust-bio style
// band of the reference tool, k = 6, w = 20): k-mer matches between a read
// and a haplotype are chained with a sparse DP, and the best chain's anchors
// widened by w, the boxes between consecutive anchors and the diagonal runs
// from the first and last anchor to the matrix edges give each read row i
// one column interval [jlo[i], jhi[i]). The banded DP (csrc/sw_banded.cu and
// its plain version ops/sw_banded_torch.py) scores cells inside the band and
// reads H = 0, E = F = NEG outside it.
//
// Result kinds, as in the JAX package's banded_bounds_batch:
//   * no shared k-mer: every row empty, [0, 0) (score 0);
//   * read or haplotype shorter than k: the full band [0, len_y) on every
//     row of the read (the full-SW score);
//   * otherwise the chained band; uncovered rows empty.
// Rows at or past the read's length are empty. Bounds are int32, so
// haplotypes of any width keep exact bounds.
//
// One C entry, band_bounds_pairs, takes the padded matrices the pipeline
// holds (reads pad 0, haplotypes pad 1, rows picked by index) and writes the
// bounds in the kernel's [row][problem] layout, threaded over problems.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC -pthread
// (vartrix_tpu_torch/ops/_build.py band_bounds_library).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int32_t MATCH = 1;
constexpr int32_t GAP_OPEN = -5;
constexpr int32_t GAP_EXTEND = -1;
constexpr int K = 6;   // k-mer length of the seeds
constexpr int W = 20;  // half-width of the band around an anchor

// Chained band of x (lx bases) against y (ly bases) into jlo/jhi (size lx),
// with k = K and w = W.
// Returns 0 = no k-mer seed (empty band), 1 = banded, 2 = a sequence
// shorter than k (full band). Same construction as native/swlib.cpp:165-284.
int build_chained_band(const uint8_t* x, int32_t lx, const uint8_t* y,
                       int32_t ly, int k, int w, std::vector<int32_t>& jlo,
                       std::vector<int32_t>& jhi) {
  if (lx < k || ly < k) return 2;
  // hash y's k-mers (open addressing, chained positions per key)
  const int32_t ny = ly - k + 1;
  static thread_local std::vector<uint64_t> keys;
  static thread_local std::vector<int32_t> head, nxt;
  int cap = 1;
  while (cap < ny * 2) cap <<= 1;
  keys.assign(cap, ~0ull);
  head.assign(cap, -1);
  nxt.assign(ny, -1);
  auto hash_kmer = [&](const uint8_t* p) {
    uint64_t h = 1469598103934665603ull;
    for (int t = 0; t < k; ++t) { h ^= p[t]; h *= 1099511628211ull; }
    return h;
  };
  for (int32_t j = 0; j < ny; ++j) {
    uint64_t h = hash_kmer(y + j);
    uint32_t slot = (uint32_t)h & (cap - 1);
    while (keys[slot] != ~0ull && keys[slot] != h) slot = (slot + 1) & (cap - 1);
    keys[slot] = h;
    nxt[j] = head[slot];
    head[slot] = j;
  }
  // matches (i, j), ordered by (i, j)
  static thread_local std::vector<std::pair<int32_t, int32_t>> matches;
  matches.clear();
  for (int32_t i = 0; i + k <= lx; ++i) {
    uint64_t h = hash_kmer(x + i);
    uint32_t slot = (uint32_t)h & (cap - 1);
    while (keys[slot] != ~0ull) {
      if (keys[slot] == h) {
        for (int32_t j = head[slot]; j != -1; j = nxt[j]) {
          if (memcmp(x + i, y + j, k) == 0) matches.emplace_back(i, j);
        }
        break;
      }
      slot = (slot + 1) & (cap - 1);
    }
  }
  if (matches.empty()) return 0;
  std::sort(matches.begin(), matches.end());
  // sparse chain DP: k * MATCH per anchor minus an affine penalty for the
  // (di, dj) jump between consecutive anchors, at most 64 predecessors
  const size_t m = matches.size();
  static thread_local std::vector<int64_t> chain_sc;
  static thread_local std::vector<int32_t> prev;
  chain_sc.assign(m, 0);
  prev.assign(m, -1);
  int64_t best_sc = -1;
  size_t best_i = 0;
  const size_t MAX_PRED = 64;
  for (size_t a = 0; a < m; ++a) {
    chain_sc[a] = (int64_t)k * MATCH;
    size_t seen = 0;
    for (size_t b = a; b-- > 0 && seen < MAX_PRED;) {
      ++seen;
      if (matches[b].first >= matches[a].first ||
          matches[b].second >= matches[a].second)
        continue;
      int64_t di = matches[a].first - matches[b].first;
      int64_t dj = matches[a].second - matches[b].second;
      int64_t gap = std::max(di, dj) - std::min(di, dj);
      int64_t pen = gap > 0 ? -(GAP_OPEN + gap * GAP_EXTEND) : 0;
      int64_t overlap = std::max<int64_t>(0, k - std::min(di, dj));
      int64_t sc = chain_sc[b] + (int64_t)(k - overlap) * MATCH - pen;
      if (sc > chain_sc[a]) { chain_sc[a] = sc; prev[a] = (int32_t)b; }
    }
    if (chain_sc[a] > best_sc) { best_sc = chain_sc[a]; best_i = a; }
  }
  // best chain, front to back
  static thread_local std::vector<std::pair<int32_t, int32_t>> path;
  path.clear();
  for (int32_t a = (int32_t)best_i; a != -1; a = prev[a])
    path.push_back(matches[a]);
  std::reverse(path.begin(), path.end());
  jlo.assign(lx, INT32_MAX);
  jhi.assign(lx, INT32_MIN);
  auto add_box = [&](int32_t i0, int32_t i1, int32_t j0, int32_t j1) {
    i0 = std::max(0, i0); i1 = std::min(lx, i1);
    j0 = std::max(0, j0); j1 = std::min(ly, j1);
    for (int32_t r = i0; r < i1; ++r) {
      jlo[r] = std::min(jlo[r], j0);
      jhi[r] = std::max(jhi[r], j1);
    }
  };
  auto add_diag = [&](int32_t i0, int32_t j0, int32_t len) {
    for (int32_t t = -w; t < len + w; ++t) {
      int32_t r = i0 + t;
      if (r < 0 || r >= lx) continue;
      jlo[r] = std::min(jlo[r], std::max(0, j0 + t - w));
      jhi[r] = std::max(jhi[r], std::min(ly, j0 + t + w + 1));
    }
  };
  for (size_t a = 0; a < path.size(); ++a) {
    add_diag(path[a].first, path[a].second, k);
    if (a + 1 < path.size()) {
      add_box(path[a].first, path[a + 1].first + k,
              path[a].second, path[a + 1].second + k);
    }
  }
  // corner extensions along the chain's end diagonals
  {
    int32_t i0 = path.front().first, j0 = path.front().second;
    int32_t back = std::min(i0, j0);
    add_diag(i0 - back, j0 - back, back);
    int32_t i1 = path.back().first + k, j1 = path.back().second + k;
    int32_t fwd = std::min(lx - i1, ly - j1);
    add_diag(i1, j1, fwd);
  }
  return 1;
}

template <typename F>
void parallel_for(int64_t n, int n_threads, F&& body) {
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) body(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(64);
        if (i >= n) return;
        int64_t end = std::min(n, i + 64);
        for (int64_t j = i; j < end; ++j) body(j);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// true length of a padded row: up to its last byte that is not `pad`
int32_t true_len(const uint8_t* row, int32_t width, uint8_t pad) {
  while (width > 0 && row[width - 1] == pad) --width;
  return width;
}

}  // namespace

extern "C" {

// Band bounds of 2 * n_reads problems. Problem p scores read p / 2
// (reads: uint8 [n_reads, lx], pad 0) against haplotype row idx_ref[read]
// (p even) or idx_alt[read] (p odd) of haps (uint8 [*, ly], pad 1).
// jlo_out, jhi_out: int32 [lx, 2 * n_reads], row i of problem p at
// i * 2 * n_reads + p. Indices must lie inside haps (the caller checks).
// Each task builds a block of kBlock problems' rows locally and writes them
// out row by row: one problem's rows lie a power-of-two stride apart, and
// written one by one they would all fall into the same cache sets.
void band_bounds_pairs(const uint8_t* reads, int64_t n_reads, int32_t lx,
                       const uint8_t* haps, int32_t ly,
                       const int32_t* idx_ref, const int32_t* idx_alt,
                       int32_t* jlo_out, int32_t* jhi_out, int n_threads) {
  constexpr int64_t kBlock = 64;
  const int64_t n_prob = 2 * n_reads;
  const int64_t n_blocks = (n_prob + kBlock - 1) / kBlock;
  parallel_for(n_blocks, n_threads, [&](int64_t b) {
    const int64_t p0 = b * kBlock;
    const int64_t nb = std::min(kBlock, n_prob - p0);
    static thread_local std::vector<int32_t> lo_buf, hi_buf, jlo, jhi;
    lo_buf.assign(nb * lx, 0);
    hi_buf.assign(nb * lx, 0);
    for (int64_t q = 0; q < nb; ++q) {
      const int64_t p = p0 + q;
      const int64_t read = p / 2;
      const int32_t* idx = (p & 1) ? idx_alt : idx_ref;
      const uint8_t* x = reads + read * lx;
      const uint8_t* y = haps + static_cast<int64_t>(idx[read]) * ly;
      const int32_t len_x = true_len(x, lx, 0);
      const int32_t len_y = true_len(y, ly, 1);
      if (len_x == 0 || len_y == 0) continue;
      const int kind = build_chained_band(x, len_x, y, len_y, K, W, jlo, jhi);
      if (kind == 0) continue;
      int32_t* lo = lo_buf.data() + q * lx;
      int32_t* hi = hi_buf.data() + q * lx;
      for (int32_t r = 0; r < len_x; ++r) {
        const int32_t l = kind == 2 ? 0 : jlo[r];
        const int32_t h = kind == 2 ? len_y : jhi[r];
        if (l < h) {
          lo[r] = l;
          hi[r] = h;
        }
      }
    }
    for (int32_t r = 0; r < lx; ++r) {
      for (int64_t q = 0; q < nb; ++q) {
        jlo_out[r * n_prob + p0 + q] = lo_buf[q * lx + r];
        jhi_out[r * n_prob + p0 + q] = hi_buf[q * lx + r];
      }
    }
  });
}

}  // extern "C"
