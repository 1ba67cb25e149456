// SELL-C-sigma sparse matrix times dense block Y = A X (SpMM), for NVIDIA
// Hopper (sm_90a).
//
// The matrix is pykrylov_tpu_torch.sparse.sell.SELL, read as
// csrc/sell_spmv.cu reads it (see there for the layout and why it replaces
// the BELL container on this card).  X is (n_x, K) row-major and Y
// (rows, K) row-major, the layout in which the batched solvers hold their
// blocks.  For every column k:
//
//   Y[row_idx[t], k] = sum_j vals[p_j] * X[cols[p_j], k],   j ascending.
//
// Replaces pykrylov_tpu/sparse/bell.py::_bell_mm_kernel, which computes the
// same product on a TPU over the BELL container with X relaid out
// band-major, staging each step's x window for all K columns into VMEM and
// selecting bands, lanes and blocks with one-hot MXU products.  None of
// that carries over.
//
// G = min(the power of two >= K, 32) lanes serve one slot row, and 32 / G
// slot rows share a warp (K = 8: 8 lanes a row, 4 rows a warp).  The G lanes
// of a row read each of its entries (value and column) once, as one
// broadcast load, and multiply it into their columns k = k0 + lane + G u,
// u < NA: NA = 1 up to K = 32, 2 up to 64, 4 up to 128.  A gathered row of
// X is K contiguous values, so the G lanes read it coalesced (one 32-byte
// sector at K = 8 in f32), and they write their row of Y the same way.  The
// card form is read once for every K up to 128; past that a grid dimension
// runs over chunks of 128 columns, each re-reading it.  No atomics: each
// lane writes its columns of its row once.  Blocks of 256 threads.
//
// Bound: device-memory bytes.  The product must read the matrix once (the
// smaller of the card form's bytes and its CSR bytes) and X and Y once
// each: K (n_x + rows) elements.  For tiled 1138bus at K = 8 in f32 that is
// 37.9 MB of CSR and 74.6 MB of X and Y.
//
// Products and sums are rounded one by one (no FMA contraction), in slot
// order, from 0, exactly as csrc/sell_spmv.cu computes each row: column k
// of Y equals the SpMV kernel on column k of X bit for bit, and equals the
// plain torch version (sell.sell_matmat_plain).  A column outside [0, n_x)
// is skipped.
//
// Types: f32 values with f32 X; bf16 values with f32 X (f32 compute); f64
// values with f64 X; f32 or bf16 values with f64 X (each value widened to
// double, exactly, and f64 compute).
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 32;     // slot rows per slice
constexpr int kThreads = 256;
constexpr int kMaxNA = 4;      // accumulators per lane: 128 columns a pass
constexpr int kUnroll = 4;     // entries loaded ahead of their products

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

template <typename TV, typename TC, int G, int NA>
__device__ __forceinline__ void spmm_rows(const TV* __restrict__ vals,
                                          const int32_t* __restrict__ cols,
                                          const int64_t* __restrict__ slice_ptr,
                                          const int32_t* __restrict__ row_len,
                                          const int32_t* __restrict__ row_idx,
                                          const TC* __restrict__ x, int64_t n_x,
                                          TC* __restrict__ y, int64_t rows,
                                          int64_t kcols) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t t = tid / G;  // slot row
  if (t >= rows) return;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * (G * NA) + tid % G;
  const int len = row_len[t];
  const int64_t p0 = slice_ptr[t / kSlice] + t % kSlice;
  const TV* v = vals + p0;
  const int32_t* c = cols + p0;
  TC acc[NA];
#pragma unroll
  for (int u = 0; u < NA; ++u) acc[u] = TC(0);
  for (int j = 0; j < len; j += kUnroll) {
    // a chunk's loads are all issued before its first product, past the
    // row's end too (masked), as in the SpMV
    int32_t cj[kUnroll];
    TC vj[kUnroll];
    TC xj[kUnroll][NA];
#pragma unroll
    for (int w = 0; w < kUnroll; ++w) {
      const bool live = j + w < len;
      cj[w] = live ? __ldg(c + (j + w) * kSlice) : -1;  // -1: skipped
      vj[w] = live ? static_cast<TC>(
                         to_compute(__ldg(v + (j + w) * kSlice)))
                   : TC(0);
    }
#pragma unroll
    for (int w = 0; w < kUnroll; ++w) {
      const bool inside = cj[w] >= 0 && cj[w] < n_x;
      const TC* xr = x + cj[w] * kcols + k0;
#pragma unroll
      for (int u = 0; u < NA; ++u) {
        xj[w][u] = inside && k0 + u * G < kcols ? __ldg(xr + u * G) : TC(0);
      }
    }
#pragma unroll
    for (int w = 0; w < kUnroll; ++w) {
      if (cj[w] >= 0 && cj[w] < n_x) {
#pragma unroll
        for (int u = 0; u < NA; ++u) {
          if (k0 + u * G < kcols) {
            acc[u] = add_rn(acc[u], mul_rn(vj[w], xj[w][u]));
          }
        }
      }
    }
  }
  TC* yr = y + static_cast<int64_t>(row_idx[t]) * kcols + k0;
#pragma unroll
  for (int u = 0; u < NA; ++u) {
    if (k0 + u * G < kcols) yr[u * G] = acc[u];
  }
}

#define SELL_SPMM_PARAMS                                                  \
  const TV *__restrict__ vals, const int32_t *__restrict__ cols,          \
      const int64_t *__restrict__ slice_ptr,                              \
      const int32_t *__restrict__ row_len,                                \
      const int32_t *__restrict__ row_idx, const TC *__restrict__ x,      \
      int64_t n_x, TC *__restrict__ y, int64_t rows, int64_t kcols

// One or four accumulators a lane: the registers the compiler picks.
template <typename TV, typename TC, int G, int NA>
__global__ void __launch_bounds__(kThreads)
    sell_spmm_kernel(SELL_SPMM_PARAMS) {
  spmm_rows<TV, TC, G, NA>(vals, cols, slice_ptr, row_len, row_idx, x, n_x,
                           y, rows, kcols);
}

// Two accumulators a lane (K from 33 to 64): one warp serves one row, so
// the rows in flight are the resident warps; eight resident blocks (64
// warps) a SM took 7% less device time at K = 64 on tiled 1138bus than the
// registers the compiler picks (chip_sell_variants.py), spilling a few
// bytes.  The same bound slowed the one-accumulator shapes and spills
// more at four.
template <typename TV, typename TC, int G, int NA>
__global__ void __launch_bounds__(kThreads, 8)
    sell_spmm_wide_kernel(SELL_SPMM_PARAMS) {
  spmm_rows<TV, TC, G, NA>(vals, cols, slice_ptr, row_len, row_idx, x, n_x,
                           y, rows, kcols);
}

#undef SELL_SPMM_PARAMS

template <typename TV, typename TC, int G, int NA>
void launch_shape(int64_t rows, int64_t kcols, cudaStream_t stream,
                  const TV* vals, const int32_t* cols,
                  const int64_t* slice_ptr, const int32_t* row_len,
                  const int32_t* row_idx, const TC* x, int64_t n_x, TC* y) {
  const dim3 grid(
      static_cast<unsigned int>((rows * G + kThreads - 1) / kThreads),
      static_cast<unsigned int>((kcols + G * NA - 1) / (G * NA)));
  if constexpr (NA == 2) {
    sell_spmm_wide_kernel<TV, TC, G, NA><<<grid, kThreads, 0, stream>>>(
        vals, cols, slice_ptr, row_len, row_idx, x, n_x, y, rows, kcols);
  } else {
    sell_spmm_kernel<TV, TC, G, NA><<<grid, kThreads, 0, stream>>>(
        vals, cols, slice_ptr, row_len, row_idx, x, n_x, y, rows, kcols);
  }
}

template <typename TV, typename TC>
int launch(const void* vals, const void* cols, const void* slice_ptr,
           const void* row_len, const void* row_idx, const void* x,
           int64_t n_x, void* y, int64_t rows, int64_t kcols, void* stream) {
  if (rows < 1 || n_x < 0 || kcols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int g = 1;
  while (g < kcols && g < kSlice) g *= 2;
  int na = 1;
  while (g * na < kcols && na < kMaxNA) na *= 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TV* v = static_cast<const TV*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const int64_t* sp = static_cast<const int64_t*>(slice_ptr);
  const int32_t* rl = static_cast<const int32_t*>(row_len);
  const int32_t* ri = static_cast<const int32_t*>(row_idx);
  const TC* xx = static_cast<const TC*>(x);
  TC* yy = static_cast<TC*>(y);
#define SELL_SHAPE(G, NA) \
  launch_shape<TV, TC, G, NA>(rows, kcols, s, v, c, sp, rl, ri, xx, n_x, yy)
  switch (g * na) {
    case 1: SELL_SHAPE(1, 1); break;
    case 2: SELL_SHAPE(2, 1); break;
    case 4: SELL_SHAPE(4, 1); break;
    case 8: SELL_SHAPE(8, 1); break;
    case 16: SELL_SHAPE(16, 1); break;
    case 32: SELL_SHAPE(32, 1); break;
    case 64: SELL_SHAPE(32, 2); break;
    default: SELL_SHAPE(32, 4); break;
  }
#undef SELL_SHAPE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SELL_ENTRY(NAME, TV, TC)                                            \
  int NAME(const void* vals, const void* cols, const void* slice_ptr,       \
           const void* row_len, const void* row_idx, const void* x,         \
           int64_t n_x, void* y, int64_t rows, int64_t kcols,               \
           void* stream) {                                                  \
    return launch<TV, TC>(vals, cols, slice_ptr, row_len, row_idx, x, n_x,  \
                          y, rows, kcols, stream);                          \
  }

extern "C" {

SELL_ENTRY(sell_spmm_f32, float, float)
SELL_ENTRY(sell_spmm_bf16, __nv_bfloat16, float)
SELL_ENTRY(sell_spmm_f64, double, double)
SELL_ENTRY(sell_spmm_f32f64, float, double)
SELL_ENTRY(sell_spmm_bf16f64, __nv_bfloat16, double)

}  // extern "C"
