// Native host-side data pipeline for pykrylov_tpu_torch.
//
// The host-side work that feeds the port's CUDA kernels, in C++:
// MatrixMarket parsing, COO -> ELL / DIA fills, per-row counts, and the
// BELL packer's window planners.  These routines only prepare host
// buffers, so they expose a plain extern "C" ABI that
// pykrylov_tpu_torch/native/__init__.py binds with ctypes.  Each output
// equals the NumPy path's array for array (io/matrix_market.py,
// sparse/formats.py, sparse/bell.py), which the callers take where the
// library is unavailable.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC native.cpp -o libnative_<hash>.so
// (done at first use by pykrylov_tpu_torch/native/__init__.py, into
// pykrylov_tpu_torch/_build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

namespace {

struct MMHandle {
  std::vector<double> vals;   // interleaved re,im when complex
  std::vector<int32_t> rows;
  std::vector<int32_t> cols;
  int64_t m = 0, n = 0;
  int field = 0;     // 0 real, 1 integer, 2 pattern, 3 complex
  int symmetry = 0;  // 0 general, 1 symmetric, 2 skew-symmetric, 3 hermitian
};

// Skip spaces/tabs.
inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

bool line_starts(const std::string& s, const char* prefix) {
  return s.rfind(prefix, 0) == 0;
}

std::string lower(std::string s) {
  for (auto& c : s) c = (char)tolower((unsigned char)c);
  return s;
}

}  // namespace

extern "C" {

// Parse a MatrixMarket coordinate file.  Returns an opaque handle (or
// nullptr, with a message in errbuf).  Metadata comes back through the out
// params; the caller then sizes numpy arrays and calls mm_copy + mm_free.
void* mm_parse(const char* path, int64_t* out_nnz, int64_t* out_m,
               int64_t* out_n, int* out_field, int* out_symmetry,
               char* errbuf, int errlen) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(errbuf, errlen, "cannot open %s", path);
    return nullptr;
  }
  auto fail = [&](const char* msg) -> void* {
    snprintf(errbuf, errlen, "%s", msg);
    fclose(f);
    return nullptr;
  };

  char buf[1 << 16];
  if (!fgets(buf, sizeof buf, f)) return fail("empty file");
  std::string header = lower(buf);
  if (!line_starts(header, "%%matrixmarket"))
    return fail("not a MatrixMarket file");
  if (header.find("matrix") == std::string::npos ||
      header.find("coordinate") == std::string::npos)
    return fail("only 'matrix coordinate' files supported natively");

  auto h = new MMHandle();
  if (header.find("complex") != std::string::npos) h->field = 3;
  else if (header.find("integer") != std::string::npos) h->field = 1;
  else if (header.find("pattern") != std::string::npos) h->field = 2;
  else h->field = 0;
  if (header.find("skew-symmetric") != std::string::npos) h->symmetry = 2;
  else if (header.find("symmetric") != std::string::npos) h->symmetry = 1;
  else if (header.find("hermitian") != std::string::npos) h->symmetry = 3;
  else h->symmetry = 0;

  // Comments, then the size line.
  int64_t nnz = -1;
  while (fgets(buf, sizeof buf, f)) {
    const char* p = skip_ws(buf);
    if (*p == '%' || *p == '\n' || *p == '\0') continue;
    char* end;
    h->m = strtoll(p, &end, 10);
    h->n = strtoll(end, &end, 10);
    nnz = strtoll(end, &end, 10);
    break;
  }
  if (nnz < 0 || h->m <= 0 || h->n <= 0) {
    delete h;
    return fail("bad size line");
  }

  h->rows.reserve(nnz);
  h->cols.reserve(nnz);
  h->vals.reserve(h->field == 3 ? 2 * nnz : nnz);

  while ((int64_t)h->rows.size() < nnz && fgets(buf, sizeof buf, f)) {
    const char* p = skip_ws(buf);
    if (*p == '%' || *p == '\n' || *p == '\0') continue;
    char* end;
    long r = strtol(p, &end, 10);
    long c = strtol(end, &end, 10);
    h->rows.push_back((int32_t)(r - 1));  // 1-based -> 0-based
    h->cols.push_back((int32_t)(c - 1));
    if (h->field == 2) {
      h->vals.push_back(1.0);
    } else if (h->field == 3) {
      h->vals.push_back(strtod(end, &end));
      h->vals.push_back(strtod(end, &end));
    } else {
      h->vals.push_back(strtod(end, &end));
    }
  }
  fclose(f);
  if ((int64_t)h->rows.size() != nnz) {
    snprintf(errbuf, errlen, "expected %lld entries, got %lld",
             (long long)nnz, (long long)h->rows.size());
    delete h;  // after the message, which reads its count
    return nullptr;
  }
  *out_nnz = nnz;
  *out_m = h->m;
  *out_n = h->n;
  *out_field = h->field;
  *out_symmetry = h->symmetry;
  return h;
}

void mm_copy(void* handle, double* vals, int32_t* rows, int32_t* cols) {
  auto h = static_cast<MMHandle*>(handle);
  memcpy(vals, h->vals.data(), h->vals.size() * sizeof(double));
  memcpy(rows, h->rows.data(), h->rows.size() * sizeof(int32_t));
  memcpy(cols, h->cols.data(), h->cols.size() * sizeof(int32_t));
}

void mm_free(void* handle) { delete static_cast<MMHandle*>(handle); }

// Fill padded-row ELL storage from row-sorted COO triples.
// ell_data (m*K) and ell_cols (m*K) must be zero-initialized.
// Returns 0 on success, -1 if some row exceeds K slots.
int ell_fill(int64_t nnz, const int32_t* rows, const int32_t* cols,
             const double* vals, int64_t m, int64_t K, double* ell_data,
             int32_t* ell_cols) {
  std::vector<int32_t> slot(m, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    const int32_t r = rows[i];
    const int32_t s = slot[r]++;
    if (s >= K) return -1;
    ell_data[(int64_t)r * K + s] = vals[i];
    ell_cols[(int64_t)r * K + s] = cols[i];
  }
  return 0;
}

// Fill DIA storage: dia_data is (ndiag, m) zero-initialized; offsets are
// the sorted distinct diagonals.  Returns 0, or -1 on an unknown offset.
int dia_fill(int64_t nnz, const int32_t* rows, const int32_t* cols,
             const double* vals, int64_t m, int64_t ndiag,
             const int64_t* offsets, double* dia_data) {
  // offsets are sorted: binary search each nnz's diagonal.
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t off = (int64_t)cols[i] - rows[i];
    int64_t lo = 0, hi = ndiag - 1, k = -1;
    while (lo <= hi) {
      const int64_t mid = (lo + hi) / 2;
      if (offsets[mid] == off) { k = mid; break; }
      if (offsets[mid] < off) lo = mid + 1; else hi = mid - 1;
    }
    if (k < 0) return -1;
    dia_data[k * m + rows[i]] += vals[i];  // duplicates accumulate
  }
  return 0;
}

// Per-row nonzero counts (bincount for int32 rows).
void row_counts(int64_t nnz, const int32_t* rows, int64_t m,
                int64_t* counts) {
  memset(counts, 0, m * sizeof(int64_t));
  for (int64_t i = 0; i < nnz; ++i) counts[rows[i]]++;
}

// ---------------------------------------------------------------------
// BELL window planning (the per-block DP of sparse/bell.py, the
// packer's hot spot in Python).
//
// Inputs are (row, col)-sorted COO structure.  Per 128-row block: build
// per-(band, lane) counts, run the 1-/2-band window DP minimizing
// streamed bytes with an optional byte-optimal depth cap (entries deeper
// than the cap spill), and emit per-entry window base band / window row
// offset / cap plus the capped total depth per block.  Mirrors
// _plan_block_windows/_capped_depth in sparse/bell.py exactly.
// ---------------------------------------------------------------------

namespace {

constexpr int kLanes = 128;
constexpr double kSlotBytes = 5.0;

// Byte-optimal capped depth for one window given per-lane counts.
// cost(d) = 5*128*d + spill*overflow(d); returns best d (cost via *out).
int64_t capped_depth(const int32_t* c, double spill, bool use_spill,
                     double* out_cost) {
  int32_t cmax = 0;
  int64_t total = 0;
  for (int r = 0; r < kLanes; ++r) {
    if (c[r] > cmax) cmax = c[r];
    total += c[r];
  }
  if (cmax == 0) { *out_cost = 0.0; return 0; }
  if (!use_spill) {
    *out_cost = kSlotBytes * kLanes * (double)cmax;
    return cmax;
  }
  // histogram of counts -> overflow(d) by suffix sums
  std::vector<int64_t> hist(cmax + 1, 0);
  for (int r = 0; r < kLanes; ++r) hist[c[r]]++;
  double best = spill * (double)total;  // d = 0: everything spills
  int64_t bestd = 0;
  int64_t over = total;     // overflow(d) = sum max(c_r - d, 0)
  int64_t deeper = kLanes;  // #lanes with count > d
  for (int64_t d = 1; d <= cmax; ++d) {
    deeper -= hist[d - 1];
    over -= deeper;
    const double cost = kSlotBytes * kLanes * (double)d
                        + spill * (double)over;
    if (cost < best) { best = cost; bestd = d; }
  }
  *out_cost = best;
  return bestd;
}

}  // namespace

// Plan every block's windows.  rows/cols are (row, col)-sorted int64;
// spill_cost < 0 disables spilling.  Outputs (length nnz): e_base,
// e_woff, e_cap; depth_per_block has length nblocks (>= 1 enforced by
// the caller).  Returns 0.
int bell_plan(int64_t nnz, const int64_t* rows, const int64_t* cols,
              int64_t nblocks, double spill_cost,
              int64_t* e_base, int64_t* e_woff, int64_t* e_cap,
              int64_t* depth_per_block) {
  const bool use_spill = spill_cost >= 0.0;
  memset(depth_per_block, 0, nblocks * sizeof(int64_t));
  int64_t lo = 0;
  // scratch reused across blocks
  std::vector<int64_t> bands;          // present bands, ascending
  std::vector<int32_t> counts;         // (nbands, 128) lane counts
  std::vector<double> dp;
  std::vector<int8_t> choice;
  std::vector<int64_t> dcap;
  std::vector<int32_t> pairc(kLanes);
  while (lo < nnz) {
    const int64_t blk = rows[lo] / kLanes;
    int64_t hi = lo;
    while (hi < nnz && rows[hi] / kLanes == blk) ++hi;

    // present bands (entries are row-then-col sorted, so bands are NOT
    // globally sorted within the block: collect + sort unique)
    bands.clear();
    for (int64_t i = lo; i < hi; ++i) bands.push_back(cols[i] / kLanes);
    std::sort(bands.begin(), bands.end());
    bands.erase(std::unique(bands.begin(), bands.end()), bands.end());
    const int64_t nb = (int64_t)bands.size();

    counts.assign(nb * kLanes, 0);
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t b = cols[i] / kLanes;
      const int64_t j = std::lower_bound(bands.begin(), bands.end(), b)
                        - bands.begin();
      counts[j * kLanes + (rows[i] % kLanes)]++;
    }

    // DP over bands with 1- or 2-band (adjacent) windows
    dp.assign(nb + 1, 0.0);
    choice.assign(nb + 1, 1);
    dcap.assign(nb + 1, 0);
    for (int64_t j = 1; j <= nb; ++j) {
      double c1;
      const int64_t d1 = capped_depth(&counts[(j - 1) * kLanes],
                                      spill_cost, use_spill, &c1);
      dp[j] = dp[j - 1] + c1;
      choice[j] = 1;
      dcap[j] = d1;
      if (j >= 2 && bands[j - 1] == bands[j - 2] + 1) {
        for (int r = 0; r < kLanes; ++r)
          pairc[r] = counts[(j - 1) * kLanes + r]
                     + counts[(j - 2) * kLanes + r];
        double c2;
        const int64_t d2 = capped_depth(pairc.data(), spill_cost,
                                        use_spill, &c2);
        if (dp[j - 2] + c2 < dp[j]) {
          dp[j] = dp[j - 2] + c2;
          choice[j] = 2;
          dcap[j] = d2;
        }
      }
    }

    // backtrack -> per-band window id, start, capped depth, row offset
    std::vector<int64_t> wstart, wdepth;
    std::vector<int8_t> wwidth;
    for (int64_t j = nb; j > 0;) {
      const int w = choice[j];
      wstart.push_back(bands[j - w]);
      wdepth.push_back(dcap[j]);
      wwidth.push_back((int8_t)w);
      j -= w;
    }
    std::reverse(wstart.begin(), wstart.end());
    std::reverse(wdepth.begin(), wdepth.end());
    std::reverse(wwidth.begin(), wwidth.end());

    // band -> (window base, window row offset, cap)
    std::vector<int64_t> b2base(nb), b2off(nb), b2cap(nb);
    int64_t off = 0, bi = 0, total = 0;
    for (size_t w = 0; w < wstart.size(); ++w) {
      for (int k = 0; k < wwidth[w]; ++k, ++bi) {
        b2base[bi] = wstart[w];
        b2off[bi] = off;
        b2cap[bi] = wdepth[w];
      }
      off += wdepth[w];
      total += wdepth[w];
    }
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t b = cols[i] / kLanes;
      const int64_t j = std::lower_bound(bands.begin(), bands.end(), b)
                        - bands.begin();
      e_base[i] = b2base[j];
      e_woff[i] = b2off[j];
      e_cap[i] = b2cap[j];
    }
    depth_per_block[blk] = total;
    lo = hi;
  }
  return 0;
}

// Single-sort planning for the window=1 (v3) BELL layout.
//
// Sorts entries by (block, band, row, col) via one composite 62-bit key
// (blk and band each fit 24 bits for row/col < 2^31), then derives in
// one linear walk everything the Python packer needs: the sorted
// permutation, per-entry window cap / row offset, the per-entry ordinal
// within its (row, window) group, and per-block total depth.  It
// stands in for the NumPy pipeline of lexsort + run-flag cumsums
// (_plan_bands_sorted).  spill_cost < 0 disables spilling
// (cap = per-window max lane count); otherwise cap is the t-th largest
// lane count with t = ceil(5*128/spill_cost) (see _plan_bands_sorted).
// Outputs (length nnz): order, rs, cs (sorted rows/cols), e_woff,
// e_cap, k_ord; depth_per_block has length nblocks.  Returns 0, or 1
// when a row/col exceeds 2^31 (caller falls back to NumPy).
int bell_sort_plan_w1(int64_t nnz, const int64_t* rows,
                      const int64_t* cols, int64_t nblocks,
                      double spill_cost, int64_t* order, int64_t* rs,
                      int64_t* cs, int64_t* e_woff, int64_t* e_cap,
                      int64_t* k_ord, int64_t* depth_per_block) {
  const bool use_spill = spill_cost >= 0.0;
  const int64_t t_spill =
      use_spill ? (int64_t)std::ceil(5.0 * 128.0 / spill_cost) : 0;
  memset(depth_per_block, 0, nblocks * sizeof(int64_t));
  std::vector<std::pair<uint64_t, uint32_t>> kv(nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t r = rows[i], c = cols[i];
    if (r < 0 || c < 0 || r >= (1LL << 31) || c >= (1LL << 31)) return 1;
    uint64_t key = ((uint64_t)(r >> 7) << 38) | ((uint64_t)(c >> 7) << 14)
                   | ((uint64_t)(r & 127) << 7) | (uint64_t)(c & 127);
    kv[i] = {key, (uint32_t)i};
  }
  std::sort(kv.begin(), kv.end());
  for (int64_t i = 0; i < nnz; ++i) {
    order[i] = kv[i].second;
    rs[i] = rows[kv[i].second];
    cs[i] = cols[kv[i].second];
  }
  // one pass over (block, band) window runs
  std::vector<int64_t> lane_counts;
  int64_t i = 0;
  while (i < nnz) {
    uint64_t wkey = kv[i].first >> 14;         // (blk, band)
    int64_t blk = (int64_t)(kv[i].first >> 38);
    int64_t j = i;
    lane_counts.clear();
    while (j < nnz && (kv[j].first >> 14) == wkey) {
      int64_t lane = (kv[j].first >> 7) & 127;
      int64_t j2 = j;
      while (j2 < nnz && ((kv[j2].first >> 7) & 127) == lane
             && (kv[j2].first >> 14) == wkey)
        ++j2;
      lane_counts.push_back(j2 - j);
      // ordinal within the (row, window) group
      for (int64_t q = j; q < j2; ++q) k_ord[q] = q - j;
      j = j2;
    }
    int64_t cap;
    if (!use_spill || t_spill < 1) {
      cap = *std::max_element(lane_counts.begin(), lane_counts.end());
    } else if (t_spill > 128) {
      cap = 0;
    } else if ((int64_t)lane_counts.size() < t_spill) {
      cap = 0;  // fewer than t lanes present: t-th largest count is 0
    } else {
      std::nth_element(lane_counts.begin(),
                       lane_counts.begin() + (t_spill - 1),
                       lane_counts.end(), std::greater<int64_t>());
      cap = lane_counts[t_spill - 1];
    }
    int64_t woff = depth_per_block[blk];
    for (int64_t q = i; q < j; ++q) {
      e_woff[q] = woff;
      e_cap[q] = cap;
    }
    depth_per_block[blk] += cap;
    i = j;
  }
  return 0;
}

}  // extern "C"
