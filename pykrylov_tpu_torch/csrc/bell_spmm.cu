// BELL (band-sliced ELL) sparse matrix times dense block Y = A X (SpMM),
// for NVIDIA Hopper (sm_90a).
//
// The container is pykrylov_tpu_torch.sparse.bell.BELL, read exactly as
// csrc/bell_spmv.cu reads it (see there for the slot layout, the packed or
// byte indices, segmented bands and the group map grp_ptr/grp_idx).  X is
// (n_x, K) row-major and Y (rows_out, K) row-major, the layout in which the
// batched solvers hold their blocks: a gathered row of X is K contiguous
// values (one 32-byte sector at K = 8 in f32), so X needs no band-major
// copy.  For every column k:
//
//   Y[128 (st nblk + blk(st, g)) + r, k] += data[st, q, r]
//       * X[128 (band_lo[st] + base(st, q)) + idx(st, q, r), k]
//
// Replaces pykrylov_tpu/sparse/bell.py::_bell_mm_kernel, which computes the
// same product on a TPU over X relaid out band-major as (nbands, K * 128)
// (_to_band_major), staging each step's x window for all K columns into
// VMEM and selecting bands, lanes and output blocks with one-hot MXU
// products; wide blocks were cut into K chunks at the XLA level to fit
// scoped VMEM.  None of that carries over.  Here, as in the SpMV, one
// 128-thread block computes one (step, block) pair, one thread per output
// row (lane), walking the pair's 4-row groups through the group map; each
// thread reads a slot's value and index once and multiplies it into a
// tile of KT columns, whose accumulators it holds in registers.  A grid
// dimension runs over the ceil(K / KT) column tiles, with KT the smallest
// power of two >= K up to 32: for K <= 32 the slot stream is read once per
// block product, for K = 64 twice (each tile re-reads the values, indices,
// bands and map of every group it walks; X and Y are read and written once
// in all).  One launch per level per block product, for any K >= 1.  No
// atomics: each thread writes its row's tile of Y once.
//
// Bound: device-memory bytes.  The product must read the matrix once and
// X and Y once each: the smaller of the container's own bytes (slot values
// and indices, bands and map) and the matrix's CSR bytes (f32 values,
// int32 column indices and row pointers), plus K * (n_x + rows_out)
// elements of X and Y.  For 1138bus tiled 1024 times at K = 8 in f32 that
// is 37.9 MB of CSR (the container itself is about 167 MB) and 74.6 MB of
// X and Y, 112.4 MB in all.
//
// Products and sums are rounded one by one (no FMA contraction), in the
// SpMV's order for every column: a group sums ((p0 + p1) + p2) + p3, the
// accumulator adds group sums in ascending group position, and
// `accumulate` adds the result into Y (the next level of a multi-level
// packing).  Column k of Y therefore equals csrc/bell_spmv.cu on column k
// of X bit for bit.  Every slot of a walked group is multiplied, padding
// included; columns outside [0, n_x) count as zero; rows >= rows_out are
// not written.
//
// Types: f32 values with f32 X; bf16 values with f32 X (f32 compute); f64
// values with f64 X.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kSegRows = 256;
constexpr int kMaxTile = 32;

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

template <typename TD, typename TC, int KT>
__global__ void __launch_bounds__(kLanes)
    bell_spmm_kernel(const TD* __restrict__ data,
                     const uint32_t* __restrict__ packed,
                     const uint8_t* __restrict__ bytes,
                     const int32_t* __restrict__ bands, int64_t bands_stride,
                     const int32_t* __restrict__ band_lo,
                     const int32_t* __restrict__ seg, int nseg,
                     const int32_t* __restrict__ grp_ptr,
                     const int32_t* __restrict__ grp_idx,
                     const TC* __restrict__ x, int64_t n_x,
                     TC* __restrict__ y, int64_t rows_out, int nblk, int gs,
                     int kcols, int accumulate) {
  const int64_t pair = blockIdx.x;  // (step, block) = st * nblk + blk
  const int lane = threadIdx.x;
  const int64_t row = pair * kLanes + lane;
  const int64_t st = pair / nblk;
  const int k0 = blockIdx.y * KT;
  const int kc = kcols - k0 < KT ? kcols - k0 : KT;  // columns of this tile
  const int gq = gs / 4;
  const TD* d = data + st * gs * kLanes + lane;
  const int32_t* bs = bands + st * bands_stride;
  const int32_t* sg = seg != nullptr ? seg + st * nseg : nullptr;
  const int64_t x0 = static_cast<int64_t>(band_lo[st]) * kLanes;
  const TC* xt = x + k0;

  TC acc[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = TC(0);

  const int k_end = grp_ptr[pair + 1];
  for (int k = grp_ptr[pair]; k < k_end; ++k) {
    const int g = grp_idx[k];
    TC v[4];
    int64_t col[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = 4 * g + j;
      v[j] = to_compute(d[static_cast<int64_t>(q) * kLanes]);
      int idx;
      if (packed != nullptr) {
        const uint32_t word = packed[(st * gq + q % gq) * kLanes + lane];
        idx = static_cast<int>((word >> (8 * (q / gq))) & 255u);
      } else {
        idx = bytes[(st * gs + q) * kLanes + lane];
      }
      int base = bs[q];
      if (sg != nullptr) {
        const int s = sg[q / kSegRows];
        if (s >= 0) base += s;
      }
      const int64_t c = x0 + static_cast<int64_t>(base) * kLanes + idx;
      col[j] = c >= 0 && c < n_x ? c * kcols : -1;  // -1: outside X
    }
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      if (t < kc) {
        TC gsum = TC(0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const TC p = col[j] >= 0 ? mul_rn(v[j], xt[col[j] + t]) : TC(0);
          gsum = j == 0 ? p : add_rn(gsum, p);
        }
        acc[t] = add_rn(acc[t], gsum);
      }
    }
  }
  if (row < rows_out) {
    TC* yr = y + row * kcols + k0;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      if (t < kc) yr[t] = accumulate ? add_rn(yr[t], acc[t]) : acc[t];
    }
  }
}

template <typename TD, typename TC, int KT>
void launch_tile(dim3 grid, cudaStream_t stream, const TD* data,
                 const uint32_t* packed, const uint8_t* bytes,
                 const int32_t* bands, int64_t bands_stride,
                 const int32_t* band_lo, const int32_t* seg, int nseg,
                 const int32_t* grp_ptr, const int32_t* grp_idx, const TC* x,
                 int64_t n_x, TC* y, int64_t rows_out, int nblk, int gs,
                 int kcols, int accumulate) {
  bell_spmm_kernel<TD, TC, KT><<<grid, kLanes, 0, stream>>>(
      data, packed, bytes, bands, bands_stride, band_lo, seg, nseg, grp_ptr,
      grp_idx, x, n_x, y, rows_out, nblk, gs, kcols, accumulate);
}

template <typename TD, typename TC>
int launch(const void* data, const void* lanes, int idx_packed,
           const void* bands, int64_t bands_stride, const void* band_lo,
           const void* seg, int nseg, const void* grp_ptr,
           const void* grp_idx, const void* x, int64_t n_x, void* y,
           int64_t rows_out, int nsteps, int gs, int nblk, int kcols,
           int accumulate, void* stream) {
  if (nsteps < 1 || nblk < 1 || gs < 4 || gs % 4 != 0 || rows_out < 1 ||
      kcols < 1 || (seg != nullptr && nseg < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t pairs = static_cast<int64_t>(nsteps) * nblk;
  const int64_t needed = (rows_out + kLanes - 1) / kLanes;
  if (needed < pairs) pairs = needed;
  int kt = 1;
  while (kt < kcols && kt < kMaxTile) kt *= 2;
  const dim3 grid(static_cast<unsigned int>(pairs),
                  static_cast<unsigned int>((kcols + kt - 1) / kt));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TD* d = static_cast<const TD*>(data);
  const uint32_t* pk =
      idx_packed ? static_cast<const uint32_t*>(lanes) : nullptr;
  const uint8_t* by =
      idx_packed ? nullptr : static_cast<const uint8_t*>(lanes);
  const int32_t* b = static_cast<const int32_t*>(bands);
  const int32_t* lo = static_cast<const int32_t*>(band_lo);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  const int32_t* gp = static_cast<const int32_t*>(grp_ptr);
  const int32_t* gi = static_cast<const int32_t*>(grp_idx);
  const TC* xx = static_cast<const TC*>(x);
  TC* yy = static_cast<TC*>(y);
#define BELL_TILE(KT)                                                        \
  launch_tile<TD, TC, KT>(grid, s, d, pk, by, b, bands_stride, lo, sg, nseg, \
                          gp, gi, xx, n_x, yy, rows_out, nblk, gs, kcols,    \
                          accumulate)
  switch (kt) {
    case 1: BELL_TILE(1); break;
    case 2: BELL_TILE(2); break;
    case 4: BELL_TILE(4); break;
    case 8: BELL_TILE(8); break;
    case 16: BELL_TILE(16); break;
    default: BELL_TILE(32); break;
  }
#undef BELL_TILE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BELL_ENTRY(NAME, TD, TC)                                             \
  int NAME(const void* data, const void* lanes, int idx_packed,              \
           const void* bands, int64_t bands_stride, const void* band_lo,     \
           const void* seg, int nseg, const void* grp_ptr,                   \
           const void* grp_idx, const void* x, int64_t n_x, void* y,         \
           int64_t rows_out, int nsteps, int gs, int nblk, int kcols,        \
           int accumulate, void* stream) {                                   \
    return launch<TD, TC>(data, lanes, idx_packed, bands, bands_stride,      \
                          band_lo, seg, nseg, grp_ptr, grp_idx, x, n_x, y,   \
                          rows_out, nsteps, gs, nblk, kcols, accumulate,     \
                          stream);                                           \
  }

extern "C" {

BELL_ENTRY(bell_spmm_f32, float, float)
BELL_ENTRY(bell_spmm_bf16, __nv_bfloat16, float)
BELL_ENTRY(bell_spmm_f64, double, double)

}  // extern "C"
