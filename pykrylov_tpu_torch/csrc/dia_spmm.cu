// DIA sparse matrix times dense block Y = A X (SpMM), for NVIDIA Hopper
// (sm_90a).
//
//   Y[i, k] = sum_d data[d, i] * X[i + offsets[d], k],   d ascending,
//
// over the unpadded DIA container of pykrylov_tpu_torch.sparse.formats:
// data is (ndiag, m) row-major, offsets holds ndiag <= 64 diagonal offsets,
// X is (n, K) row-major and Y is (m, K) row-major, the layout in which the
// batched solvers hold their blocks (no transposed copy of X or Y).  A term
// whose row i + offsets[d] of X falls outside [0, n) is skipped.
//
// Replaces pykrylov_tpu/sparse/kernels.py::_dia_mm_kernel_ring, which
// computes the same product on a TPU over diagonals packed into
// (ndiag, m/128, 128) blocks and X relaid out as (K, m/128, 128): it loads
// each diagonal block once into VMEM and multiplies it against all K
// columns, with a 4-slot VMEM ring of X blocks.  None of that layout
// carries over.  Here one thread computes one element (i, k) of Y, in a
// grid-stride loop over the m * K elements in row-major order, on a grid
// of one full wave of resident blocks.  The K threads of row i are
// neighbours, so a row's diagonal values are one address per diagonal for
// those K threads (a broadcast from L1), and its reads of X row i + off and
// its write of Y row i are K contiguous values: one 32-byte sector at
// K = 8 in f32.  One launch per block product, for any K >= 1.
//
// Bound: device-memory bytes.  The product must read the diagonals once
// and X and Y once each: (ndiag * s_d + K * (s_x + s_y)) * m bytes for a
// square matrix (s_d, s_x, s_y the storage sizes).  For the 3-D Poisson
// matrix at n = 240 (m = 13.8M, 7 diagonals, f32) and K = 8 that is
// 387.1 MB of diagonals and 884.7 MB of X and Y, 1.27 GB, against
// 2 * 7 * m * K flops.  The diagonal stream is read as in the SpMV, now
// once for K columns; the reuse of X across diagonals comes from L1 and L2
// as in the SpMV: the offsets span +-n^2 rows of X (+-1.8 MB at n = 240,
// K = 8), far inside the 50 MB L2.
//
// Products and sums are rounded one by one (no FMA contraction), in
// ascending d, exactly as csrc/dia_spmv.cu computes each row: column k of
// Y equals the SpMV kernel on column k of X bit for bit, and equals the
// plain torch version (kernels.dia_matmat_plain).
//
// Types: f32 data with f32 X; bf16 data with f32 X (converted with
// __bfloat162float, f32 compute); f64 data with f64 X.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;

struct Offsets {
  int64_t v[kMaxDiags];
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

template <typename TD, typename TC>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_kernel(const TD* __restrict__ data,
                    const __grid_constant__ Offsets offsets, int ndiag,
                    const TC* __restrict__ x, TC* __restrict__ y, int64_t m,
                    int64_t n, int64_t kcols) {
  // Element e = i * kcols + k; the grid stride advances (i, k) by
  // (sq, sr), so the loop divides only once, before it starts.
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t sq = stride / kcols;
  const int64_t sr = stride - sq * kcols;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  int64_t i = e0 / kcols;
  int64_t k = e0 - i * kcols;
  for (; i < m; i += sq, k += sr) {
    if (k >= kcols) {
      k -= kcols;
      ++i;
      if (i >= m) break;
    }
    TC acc = TC(0);
#pragma unroll 8
    for (int d = 0; d < ndiag; ++d) {
      const int64_t j = i + offsets.v[d];
      if (j >= 0 && j < n) {
        acc = add_rn(acc,
                     mul_rn(to_compute(data[d * m + i]), x[j * kcols + k]));
      }
    }
    y[i * kcols + k] = acc;
  }
}

// Blocks of the kernel that fit on one SM at once; the grid is one full
// wave of them (a part-filled last wave leaves most SMs idle).
template <typename TD, typename TC>
int resident_blocks_per_sm() {
  static const int per_sm = [] {
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, dia_spmm_kernel<TD, TC>, kThreads, 0);
    return v > 0 ? v : 1;
  }();
  return per_sm;
}

template <typename TD, typename TC>
int launch(const void* data, const void* offsets, int64_t ndiag,
           const void* x, void* y, int64_t m, int64_t n, int64_t kcols,
           void* stream) {
  if (ndiag < 0 || ndiag > kMaxDiags || m < 1 || kcols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets offs;
  const int64_t* src = static_cast<const int64_t*>(offsets);
  for (int d = 0; d < kMaxDiags; ++d) {
    offs.v[d] = d < ndiag ? src[d] : 0;
  }
  int device = 0;
  int sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (m * kcols + kThreads - 1) / kThreads;
  const int64_t cap =
      static_cast<int64_t>(sms) * resident_blocks_per_sm<TD, TC>();
  if (blocks > cap) blocks = cap;
  dia_spmm_kernel<TD, TC>
      <<<static_cast<unsigned int>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TD*>(data), offs, static_cast<int>(ndiag),
          static_cast<const TC*>(x), static_cast<TC*>(y), m, n, kcols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dia_spmm_f32(const void* data, const void* offsets, int64_t ndiag,
                 const void* x, void* y, int64_t m, int64_t n, int64_t kcols,
                 void* stream) {
  return launch<float, float>(data, offsets, ndiag, x, y, m, n, kcols,
                              stream);
}

int dia_spmm_bf16(const void* data, const void* offsets, int64_t ndiag,
                  const void* x, void* y, int64_t m, int64_t n,
                  int64_t kcols, void* stream) {
  return launch<__nv_bfloat16, float>(data, offsets, ndiag, x, y, m, n,
                                      kcols, stream);
}

int dia_spmm_f64(const void* data, const void* offsets, int64_t ndiag,
                 const void* x, void* y, int64_t m, int64_t n, int64_t kcols,
                 void* stream) {
  return launch<double, double>(data, offsets, ndiag, x, y, m, n, kcols,
                                stream);
}

}  // extern "C"
