// SELL-C-sigma sparse matrix-vector product y = A x, for NVIDIA Hopper
// (sm_90a).
//
// The matrix is pykrylov_tpu_torch.sparse.sell.SELL, the card form that a
// BellOperator derives from its BELL levels: slot row t (t < rows) computes
// output row row_idx[t] from its row_len[t] entries; the 32 slot rows of
// slice s = t / 32 store entry j of slot row t at
//
//   slice_ptr[s] + 32 j + t % 32            (column-major within a slice)
//
//   y[row_idx[t]] = sum_j vals[p_j] * x[cols[p_j]],   j ascending.
//
// Replaces pykrylov_tpu/sparse/bell.py::_bell_kernel (the TPU kernel over
// the BELL container itself), which stages each step's x window into VMEM,
// selects bands with one-hot MXU products and scatters 4-row group sums into
// its blocks.  None of that carries over, nor does the container: at its
// fill of 0.12 on tiled 1138bus the container is about 167 MB against
// 38 MB of CSR, so one pass over its slots alone takes twice cuSPARSE's
// whole CSR matvec on this card.  The card form keeps every nonzero and no
// padding: the rows are sorted by length within windows of sigma rows
// before they are cut into slices of 32, so the rows of a slice have
// nearly equal lengths (fill 0.98 at sigma = 4096 on tiled 1138bus), and a
// slice's padding, which only the shorter rows' tails make, is never read.
//
// One warp computes one slice, one thread one slot row: the thread walks
// j < row_len[t] (never a padding slot), the 32 lanes of the warp reading
// entry j of their rows as one coalesced 128-byte load of values and one of
// columns.  Those two streams are read once, so they are loaded through the
// read-only path without allocating in L1 (ld.global.nc.L1::no_allocate:
// __ldg took 1.47x the device time on tiled 1138bus and the same on the
// three bench classes, chip_sell_variants.py);
// x is gathered through the read-only path with L1 allocation, as its
// 4.7 MB (1.17M rows in f32) stay in the 50 MB L2.  A thread walks its row
// in chunks of eight entries, issuing a chunk's loads (masked past the
// row's end) before its first product: most rows of general sparsity are
// shorter than the chunk (1-18 entries, mean 3.56, on tiled 1138bus), and a
// loop that loaded one entry at a time would wait out a load round trip per
// entry.  Chunks of four took 0.99-1.26x the device time of eight on tiled
// 1138bus and the three bench classes (1.26x on the power-law class, whose
// rows reach 63 entries; chip_sell_variants.py).  Each thread writes
// y[row_idx[t]] once: no atomics, and the result does not depend on
// scheduling.  A row without entries is written with 0.  Blocks of 8 warps
// (8 slices).
//
// Bound: device-memory bytes.  A matvec must read the card form once
// (values and int32 columns of every slot, row lengths, output rows and
// slice pointers) plus x, and write y: about 52 MB on tiled 1138bus in f32,
// against 47 MB for the same product from CSR (f32 values, int32 columns
// and row pointers, x, y), which is the bound it is measured against.
//
// Products and sums are rounded one by one (__fmul_rn/__fadd_rn, no FMA
// contraction), in slot order, from 0; a column outside [0, n_x) is
// skipped.  That is what the plain torch version (sell.sell_matvec_plain)
// computes: the two agree bit for bit.
//
// Types: f32 values with f32 x; bf16 values with f32 x (converted exactly,
// f32 compute); f64 values with f64 x; f32 or bf16 values with f64 x (each
// value widened to double, exactly, and f64 compute).
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 32;     // slot rows per slice: one warp
constexpr int kThreads = 256;  // 8 slices per block
constexpr int kUnroll = 8;     // entries loaded ahead of their products

// Loads of the slot streams: read once, through the read-only path,
// without allocating a line in L1.
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ __nv_bfloat16 ld_stream(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return __ushort_as_bfloat16(v);
}
__device__ __forceinline__ int32_t ld_stream(const int32_t* p) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

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

template <typename TV, typename TC>
__global__ void __launch_bounds__(kThreads)
    sell_spmv_kernel(const TV* __restrict__ vals,
                     const int32_t* __restrict__ cols,
                     const int64_t* __restrict__ slice_ptr,
                     const int32_t* __restrict__ row_len,
                     const int32_t* __restrict__ row_idx,
                     const TC* __restrict__ x, int64_t n_x,
                     TC* __restrict__ y, int64_t rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows) return;
  const int len = row_len[t];
  const int64_t p0 = slice_ptr[t / kSlice] + t % kSlice;
  const TV* v = vals + p0;
  const int32_t* c = cols + p0;
  TC acc = TC(0);
  for (int j = 0; j < len; j += kUnroll) {
    // a chunk's loads are all issued before its first product, past the
    // row's end too (masked): a row shorter than the chunk costs one
    // round trip, not one per entry
    int32_t cj[kUnroll];
    TC vj[kUnroll];
    TC xj[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = j + u < len;
      cj[u] = live ? ld_stream(c + (j + u) * kSlice) : -1;  // -1: skipped
      vj[u] = live ? static_cast<TC>(
                         to_compute(ld_stream(v + (j + u) * kSlice)))
                   : TC(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xj[u] = cj[u] >= 0 && cj[u] < n_x ? __ldg(x + cj[u]) : TC(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cj[u] >= 0 && cj[u] < n_x) acc = add_rn(acc, mul_rn(vj[u], xj[u]));
    }
  }
  y[row_idx[t]] = acc;
}

template <typename TV, typename TC>
int launch(const void* vals, const void* cols, const void* slice_ptr,
           const void* row_len, const void* row_idx, const void* x,
           int64_t n_x, void* y, int64_t rows, void* stream) {
  if (rows < 1 || n_x < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  sell_spmv_kernel<TV, TC>
      <<<static_cast<unsigned int>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TV*>(vals), static_cast<const int32_t*>(cols),
          static_cast<const int64_t*>(slice_ptr),
          static_cast<const int32_t*>(row_len),
          static_cast<const int32_t*>(row_idx), static_cast<const TC*>(x),
          n_x, static_cast<TC*>(y), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SELL_ENTRY(NAME, TV, TC)                                          \
  int NAME(const void* vals, const void* cols, const void* slice_ptr,     \
           const void* row_len, const void* row_idx, const void* x,       \
           int64_t n_x, void* y, int64_t rows, void* stream) {            \
    return launch<TV, TC>(vals, cols, slice_ptr, row_len, row_idx, x, n_x, \
                          y, rows, stream);                               \
  }

extern "C" {

SELL_ENTRY(sell_spmv_f32, float, float)
SELL_ENTRY(sell_spmv_bf16, __nv_bfloat16, float)
SELL_ENTRY(sell_spmv_f64, double, double)
SELL_ENTRY(sell_spmv_f32f64, float, double)
SELL_ENTRY(sell_spmv_bf16f64, __nv_bfloat16, double)

}  // extern "C"
