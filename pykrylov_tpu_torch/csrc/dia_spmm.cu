// DIA sparse matrix times dense block Y = A X (SpMM), for NVIDIA Hopper
// (sm_90a).
//
//   Y[i, k] = sum_d data[d, i] * X[i + offsets[d], k],   d ascending,
//
// over the unpadded DIA container of pykrylov_tpu_torch.sparse.formats:
// data is (ndiag, m) row-major, offsets holds ndiag <= 4096 diagonal
// offsets, X is (n, K) row-major and Y is (m, K) row-major, the layout in
// which the batched solvers hold their blocks.  A term whose row
// i + offsets[d] of X falls outside [0, n) is skipped, never multiplied: a
// NaN or inf stored in such a slot does not reach Y.
//
// Replaces pykrylov_tpu/sparse/kernels.py::_dia_mm_kernel_ring, which loads
// each diagonal block once into VMEM, multiplies it against all K columns
// and reads X from HBM once through a ring of halo-extended windows.
//
// Bound: device-memory bytes.  The product reads the diagonals once and X
// and Y once each,
//
//   ndiag * m * s_d  +  K * (n * s_x + m * s_y)   bytes
//
// (s_d, s_x, s_y the storage sizes), against 2 * ndiag * m * K flops.  For
// the 3-D Poisson matrix at n = 240 (m = 13.8M, 7 diagonals, f32) that is
// 1.27 GB at K = 8 and 7.46 GB at K = 64: 0.38 and 2.23 ms at the 3.35 TB/s
// an H100 SXM publishes (NVIDIA H100 80GB HBM3, 700 W); the flops take
// 0.18 ms at its float32 rate at K = 64.
//
// The design, against what held back one thread per element (i, k)
// (measured in PERF.md section 6, chip_smoke.py and chip_dia_variants.py):
//
// 1. The K columns of a row share its work.  One thread owns a row and V
//    columns (V = 4 for f32 X, 2 for f64: 16-byte loads and stores,
//    neighbouring threads on neighbouring addresses), loads each diagonal
//    value once for its V columns, and issues kChunk diagonals' loads
//    before the chunk's first product.  Index arithmetic is 64-bit only
//    for a tile's base.  V = 1 is the path for K % V != 0 and for X that
//    is not 16-byte aligned; the wrapper chooses V.
// 2. X is reused across diagonals through the caches: a stencil's +-1
//    terms hit L1 within a tile, the +-n and +-n^2 terms L2.  X is read
//    straight from global memory: staging a tile's X windows in shared
//    memory moves the same bytes (the windows of a tile far shorter than
//    the stencil's 2 n rows are distinct rows of X) and measured slower.
// 3. The +-max|off| reuse stays in L2 at wide K.  Blocks are persistent,
//    one wave on the card, and walk tiles of kRows rows in ascending
//    order, so the tiles in flight are one band of rows.  The tiles run
//    panel-major over panels of Kc columns; the wrapper
//    (sparse/kernels.py::dia_mm_plan) picks Kc so that the reuse window
//    2 * max|off| * Kc * s_x stays within 16 MB.
// 4. Any number of diagonals up to dia_from_coo's 4096, by value in the
//    kernel's parameters as csrc/dia_spmv.cu takes them: up to 64 as int64
//    with their products off * K beside them (Offsets, the path timed
//    above), past 64 as int32 with off * K worked out in the kernel
//    (WideOffsets, 16 KB), an offset outside (-m, n) clamped to -m or n.
//
// Products and sums are rounded one by one (__fmul_rn/__fadd_rn,
// __dmul_rn/__dadd_rn; no FMA contraction), in ascending d, exactly as
// csrc/dia_spmv.cu computes each row: column k of Y equals the SpMV kernel
// on column k of X bit for bit, and equals the plain torch version
// (kernels.dia_matmat_plain).
//
// Types: f32 data with f32 X; bf16 data with f32 X (converted with
// __bfloat162float, f32 compute); f64 data with f64 X; f32 or bf16 data
// with f64 X (each stored value widened to double, exactly, and f64
// compute; V = 2 then gives 16-byte loads of X beside 4- or 2-byte loads of
// the diagonals).
//
// Each entry point launches on the given stream, does not synchronise, and
// returns a CUDA error code as an int (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 64;       // diagonals of the Offsets path
constexpr int kWideDiags = 4096;    // diagonals of the WideOffsets path
constexpr int kThreads = 256;
constexpr int kRows = 256;      // T, rows a tile (kernels.MM_ROWS)
constexpr int kChunk = 4;       // diagonals loaded ahead of their products

struct Offsets {
  int ndiag;
  int64_t min_off;
  int64_t max_off;
  int64_t off[kMaxDiags];
  int64_t xoff[kMaxDiags];     // off * K

  __device__ __forceinline__ int64_t offset(int d) const { return off[d]; }
  __device__ __forceinline__ int64_t xoffset(int d, int64_t) const {
    return xoff[d];
  }
};

struct WideOffsets {
  int ndiag;
  int64_t min_off;
  int64_t max_off;
  int32_t off[kWideDiags];     // clamped to [-m, n]

  __device__ __forceinline__ int64_t offset(int d) const { return off[d]; }
  __device__ __forceinline__ int64_t xoffset(int d, int64_t kcols) const {
    return off[d] * kcols;
  }
};

template <typename TC, int V>
struct alignas(sizeof(TC) * V) Pack {
  TC v[V];
};

__device__ __forceinline__ float to_compute(float v) { return v; }
__device__ __forceinline__ float to_compute(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double to_compute(double v) { return v; }

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// The two streams read or written once: the diagonal values and Y.
template <typename T>
__device__ __forceinline__ T load_value(const T* p) {
  return *p;
}
template <typename P>
__device__ __forceinline__ void store_block(P* p, const P& v) {
  *p = v;
}

// Row i of the block, columns [col, col + V): dr points at data[0, i], xr
// at X[i, col], yr at Y[i, col]; X has kcols columns.  CHECK tests each
// term's row of X against [0, n); a tile whose every term lies inside
// skips the test.
template <bool CHECK, int V, typename TD, typename TC, typename O>
__device__ __forceinline__ void row_product(const O& o,
                                            const TD* __restrict__ dr,
                                            int64_t m,
                                            const TC* __restrict__ xr,
                                            int64_t i, int64_t n,
                                            int64_t kcols,
                                            TC* __restrict__ yr) {
  using P = Pack<TC, V>;
  P acc;
#pragma unroll
  for (int v = 0; v < V; ++v) acc.v[v] = TC(0);
  for (int d0 = 0; d0 < o.ndiag; d0 += kChunk) {
    TC val[kChunk];
    P xv[kChunk];
    bool live[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int d = d0 + u;
      bool ok = d < o.ndiag;
      if (CHECK && ok) {
        const int64_t j = i + o.offset(d);
        ok = j >= 0 && j < n;
      }
      live[u] = ok;
      if (ok) {
        val[u] = static_cast<TC>(to_compute(load_value(dr + u * m)));
        xv[u] = *reinterpret_cast<const P*>(xr + o.xoffset(d, kcols));
      }
    }
    dr += kChunk * m;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (live[u]) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc.v[v] = add_rn(acc.v[v], mul_rn(val[u], xv[u].v[v]));
        }
      }
    }
  }
  store_block(reinterpret_cast<P*>(yr), acc);
}

template <typename TD, typename TC, int V, typename O>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_kernel(const TD* __restrict__ data,
                    const __grid_constant__ O o,
                    const TC* __restrict__ x, TC* __restrict__ y, int64_t m,
                    int64_t n, int64_t kcols, int kc) {
  const int g = kc / V;   // threads a row
  const int64_t row_tiles = (m + kRows - 1) / kRows;
  const int64_t tiles = row_tiles * (kcols / kc);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t p = t / row_tiles;
    const int64_t i0 = (t - p * row_tiles) * kRows;
    const int teff = static_cast<int>(m - i0 < kRows ? m - i0 : kRows);
    const bool inside = i0 + o.min_off >= 0 && i0 + teff + o.max_off <= n;
    // the tile's bases in 64 bits; offsets inside a tile in 32
    const TD* db = data + i0;
    const TC* xb = x + i0 * kcols + p * kc;
    TC* yb = y + i0 * kcols + p * kc;
    for (int e = threadIdx.x; e < teff * g; e += kThreads) {
      const int r = e / g;
      const int xo = r * static_cast<int>(kcols) + (e - r * g) * V;
      if (inside) {
        row_product<false, V>(o, db + r, m, xb + xo, i0 + r, n, kcols,
                              yb + xo);
      } else {
        row_product<true, V>(o, db + r, m, xb + xo, i0 + r, n, kcols,
                             yb + xo);
      }
    }
  }
}

template <typename TD, typename TC, int V, typename O>
int launch_kernel(const TD* data, const O& o, const TC* x, TC* y,
                  int64_t m, int64_t n, int64_t kcols, int kc,
                  cudaStream_t stream) {
  auto kernel = dia_spmm_kernel<TD, TC, V, O>;
  int device = 0;
  int sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent blocks: one wave, each walking tiles in ascending order
  const int64_t tiles = (m + kRows - 1) / kRows * (kcols / kc);
  int64_t blocks = static_cast<int64_t>(sms) * per_sm;
  if (blocks > tiles) blocks = tiles;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      data, o, x, y, m, n, kcols, kc);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TC, int VW, typename O>
int launch_cols(const TD* d, const O& o, int64_t v, const TC* x, TC* y,
                int64_t m, int64_t n, int64_t kcols, int kc,
                cudaStream_t s) {
  if (v == 1) return launch_kernel<TD, TC, 1>(d, o, x, y, m, n, kcols, kc, s);
  return launch_kernel<TD, TC, VW>(d, o, x, y, m, n, kcols, kc, s);
}

// An offset outside (-m, n) has no term inside the matrix; clamped to -m
// or n it still has none.
int64_t clamp_offset(int64_t off, int64_t m, int64_t n) {
  return off < -m ? -m : (off > n ? n : off);
}

// v columns a thread (1 or VW), panels of kc columns (kc divides kcols,
// v divides kc).
template <typename TD, typename TC, int VW>
int launch(const void* data, const void* offsets, int64_t ndiag, int64_t v,
           int64_t kc, const void* x, void* y, int64_t m, int64_t n,
           int64_t kcols, void* stream) {
  constexpr int64_t kMax32 = INT32_MAX;
  if (ndiag < 0 || ndiag > kWideDiags || m < 1 || kcols < 1 || kc < 1 ||
      (ndiag > kMaxDiags && (m > kMax32 || n > kMax32)) ||
      kcols % kc != 0 || (v != 1 && v != VW) || kc % v != 0 ||
      kRows * kcols >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const TD* d = static_cast<const TD*>(data);
  const TC* xs = static_cast<const TC*>(x);
  TC* ys = static_cast<TC*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(kc);
  if (ndiag <= kMaxDiags) {
    Offsets o = {};
    o.ndiag = static_cast<int>(ndiag);
    for (int k = 0; k < o.ndiag; ++k) {
      o.off[k] = off[k];
      o.xoff[k] = off[k] * kcols;
      if (k == 0 || off[k] < o.min_off) o.min_off = off[k];
      if (k == 0 || off[k] > o.max_off) o.max_off = off[k];
    }
    return launch_cols<TD, TC, VW>(d, o, v, xs, ys, m, n, kcols, c, s);
  }
  // the slots past ndiag are never read
  WideOffsets o;
  o.ndiag = static_cast<int>(ndiag);
  for (int k = 0; k < o.ndiag; ++k) {
    const int64_t a = clamp_offset(off[k], m, n);
    o.off[k] = static_cast<int32_t>(a);
    if (k == 0 || a < o.min_off) o.min_off = a;
    if (k == 0 || a > o.max_off) o.max_off = a;
  }
  return launch_cols<TD, TC, VW>(d, o, v, xs, ys, m, n, kcols, c, s);
}

}  // namespace

#define DIA_SPMM_ENTRY(NAME, TD, TC, VW)                                    \
  int NAME(const void* data, const void* offsets, int64_t ndiag, int64_t v, \
           int64_t kc, const void* x, void* y, int64_t m, int64_t n,        \
           int64_t kcols, void* stream) {                                   \
    return launch<TD, TC, VW>(data, offsets, ndiag, v, kc, x, y, m, n,      \
                              kcols, stream);                               \
  }

extern "C" {

DIA_SPMM_ENTRY(dia_spmm_f32, float, float, 4)
DIA_SPMM_ENTRY(dia_spmm_bf16, __nv_bfloat16, float, 4)
DIA_SPMM_ENTRY(dia_spmm_f64, double, double, 2)
DIA_SPMM_ENTRY(dia_spmm_f32f64, float, double, 2)
DIA_SPMM_ENTRY(dia_spmm_bf16f64, __nv_bfloat16, double, 2)

}  // extern "C"
