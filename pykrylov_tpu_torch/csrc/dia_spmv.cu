// DIA sparse matrix-vector product y = A x, for NVIDIA Hopper (sm_90a).
//
//   y[i] = sum_k data[k, i] * x[i + offsets[k]],   k ascending,
//
// over the unpadded DIA container of pykrylov_tpu_torch.sparse.formats:
// data is (ndiag, m) row-major, offsets holds ndiag <= 64 diagonal offsets,
// x has n entries and y has m.  A term whose column i + offsets[k] falls
// outside [0, n) is skipped, so x is never read out of range.
//
// Replaces pykrylov_tpu/sparse/kernels.py::_dia_kernel_ring (and
// _dia_kernel, its one-block form), which computes the same product on a
// TPU over diagonals packed into (ndiag, m/128, 128) blocks.  That kernel
// keeps each x block in a 4-slot VMEM ring so x is read from HBM once; it
// relies on zero-filled diagonal slots and explicit selects at the grid's
// edges, and may read garbage there.  None of that carries over: here one
// thread computes one row, in a grid-stride loop over a grid of one full
// wave of resident blocks, with no block or padding constraint on m or on
// the offsets.
//
// Bound: device-memory bytes.  A matvec moves (ndiag * s_d + 2 * s_x) * m
// bytes at best (s_d, s_x the storage sizes of data and x): for the 3-D
// Poisson matrix at n = 240 (m = 13.8M, 7 diagonals, f32) that is about
// 498 MB, for 2 * 7 * m flops.  Reads of data and writes of y are coalesced
// streams.  The reuse of x across diagonals comes from L1 and L2: the
// offsets span +-n^2 elements (+-230 KB at n = 240), far inside the 50 MB
// L2, so each x element is fetched from device memory about once.
//
// Products and sums are rounded one by one (__fmul_rn/__fadd_rn, no FMA
// contraction), in ascending k, which is what the plain torch version
// (formats.dia_matvec) computes: the two agree bit for bit.
//
// Types: f32 data with f32 x; bf16 data with f32 x (converted with
// __bfloat162float, f32 compute); f64 data with f64 x; f32 or bf16 data
// with f64 x (each stored value widened to double, which is exact, and f64
// compute: the plain version's .to(float64) promotion).
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
    dia_spmv_kernel(const TD* __restrict__ data,
                    const __grid_constant__ Offsets offsets, int ndiag,
                    const TC* __restrict__ x, TC* __restrict__ y, int64_t m,
                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < m; i += stride) {
    TC acc = TC(0);
#pragma unroll 8
    for (int k = 0; k < ndiag; ++k) {
      const int64_t j = i + offsets.v[k];
      if (j >= 0 && j < n) {
        // 64-bit slot index: ndiag * m passes 2^31 at 64 x 34M rows
        acc = add_rn(acc, mul_rn(static_cast<TC>(to_compute(
                                       data[k * m + i])),
                                   x[j]));
      }
    }
    y[i] = acc;
  }
}

// Blocks of the kernel that fit on one SM at once (registers bound it: 37
// per thread for f32 on sm_90a leave room for 6 blocks of 256).  The grid
// is one full wave of them; a grid of more blocks than fit leaves a
// part-filled last wave in which most SMs idle.
template <typename TD, typename TC>
int resident_blocks_per_sm() {
  static const int per_sm = [] {
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, dia_spmv_kernel<TD, TC>, kThreads, 0);
    return v > 0 ? v : 1;
  }();
  return per_sm;
}

template <typename TD, typename TC>
int launch(const void* data, const void* offsets, int64_t ndiag,
           const void* x, void* y, int64_t m, int64_t n, void* stream) {
  if (ndiag < 0 || ndiag > kMaxDiags || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets offs;
  const int64_t* src = static_cast<const int64_t*>(offsets);
  for (int k = 0; k < kMaxDiags; ++k) {
    offs.v[k] = k < ndiag ? src[k] : 0;
  }
  int device = 0;
  int sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (m + kThreads - 1) / kThreads;
  const int64_t cap =
      static_cast<int64_t>(sms) * resident_blocks_per_sm<TD, TC>();
  if (blocks > cap) blocks = cap;
  dia_spmv_kernel<TD, TC>
      <<<static_cast<unsigned int>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TD*>(data), offs, static_cast<int>(ndiag),
          static_cast<const TC*>(x), static_cast<TC*>(y), m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dia_spmv_f32(const void* data, const void* offsets, int64_t ndiag,
                 const void* x, void* y, int64_t m, int64_t n,
                 void* stream) {
  return launch<float, float>(data, offsets, ndiag, x, y, m, n, stream);
}

int dia_spmv_bf16(const void* data, const void* offsets, int64_t ndiag,
                  const void* x, void* y, int64_t m, int64_t n,
                  void* stream) {
  return launch<__nv_bfloat16, float>(data, offsets, ndiag, x, y, m, n,
                                      stream);
}

int dia_spmv_f64(const void* data, const void* offsets, int64_t ndiag,
                 const void* x, void* y, int64_t m, int64_t n,
                 void* stream) {
  return launch<double, double>(data, offsets, ndiag, x, y, m, n, stream);
}

int dia_spmv_f32f64(const void* data, const void* offsets, int64_t ndiag,
                    const void* x, void* y, int64_t m, int64_t n,
                    void* stream) {
  return launch<float, double>(data, offsets, ndiag, x, y, m, n, stream);
}

int dia_spmv_bf16f64(const void* data, const void* offsets, int64_t ndiag,
                     const void* x, void* y, int64_t m, int64_t n,
                     void* stream) {
  return launch<__nv_bfloat16, double>(data, offsets, ndiag, x, y, m, n,
                                       stream);
}

}  // extern "C"
