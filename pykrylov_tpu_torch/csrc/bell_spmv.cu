// BELL (band-sliced ELL) sparse matrix-vector product y = A x, for NVIDIA
// Hopper (sm_90a).
//
// The container is pykrylov_tpu_torch.sparse.bell.BELL: nsteps steps of
// nblk blocks of 128 rows; each step stores GS sublane rows of 128 slots.
// Slot (st, q, r) of a 4-row group g = q / 4 that belongs to block
// blk(st, g) < nblk multiplies
//
//   y[128 (st nblk + blk(st, g)) + r] += data[st, q, r]
//                                        * x[128 (band_lo[st] + base(st, q)) + idx(st, q, r)]
//
// where idx is the slot's byte index (packed: byte q / (GS/4) of word
// q % (GS/4); or one uint8 per slot), base(st, q) = bands[st, q] plus, in a
// segmented packing, seg[st, q / 256] when that is >= 0 (a narrow segment;
// the wide sentinel -8 adds nothing).  This is what bell_to_dense says the
// container means, and what bell_matvec_plain computes.
//
// Replaces pykrylov_tpu/sparse/bell.py::_bell_kernel, which computes the
// same product on a TPU: it stages each step's x window into VMEM by DMA,
// selects each sublane row's band with one-hot matrix products on the MXU,
// gathers lanes with take_along_axis and scatters the 4-row group sums into
// the step's blocks with a second one-hot product.  None of that carries
// over.  Here one thread block of 128 threads computes one (step, block)
// pair, one thread per output row (lane); the 128 lanes read each sublane
// row's values and indices as coalesced streams and gather x directly (the
// x window of a step stays in L2).  Each thread walks its block's 4-row
// groups through a small CSR map built at pack time (grp_ptr over
// nsteps*nblk pairs, grp_idx the groups of each pair in ascending position;
// dummy groups are not listed), sums each group's four products, adds the
// group sum into its accumulator, and writes its row of y once: no atomics,
// and the result does not depend on scheduling.  Every slot of a walked
// group is multiplied, padding included, as in the plain version, so a
// non-finite x element reached by a padding slot gives NaN in both.
// Columns outside [0, n_x) are skipped (the plain version's zero), so x
// needs no padded copy; rows >= rows_out are not written.
//
// Bound: device-memory bytes.  The kernel reads every slot value and index
// of the groups it walks (a packed index word is shared by four sublane
// rows of other groups) and an x element per slot (mostly from L2; a
// padding slot's gathers hit one address per sublane row); it writes y
// once.  At fill 0.12 (tiled 1138bus)
// the values alone are about 32 B per nonzero, against about 11 B per
// nonzero for the same product from CSR (f32 values, int32 indices, x, y),
// which is the bound it is measured against.
//
// Products and sums are rounded one by one (no FMA contraction): a group
// sums ((p0 + p1) + p2) + p3, the accumulator adds group sums in ascending
// group position, and `accumulate` adds the result into y (the next level
// of a multi-level packing).
//
// Types: f32 values with f32 x; bf16 values with f32 x (f32 compute); f64
// values with f64 x.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kSegRows = 256;

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
__global__ void __launch_bounds__(kLanes)
    bell_spmv_kernel(const TD* __restrict__ data,
                     const uint32_t* __restrict__ packed,
                     const uint8_t* __restrict__ bytes,
                     const int32_t* __restrict__ bands, int64_t bands_stride,
                     const int32_t* __restrict__ band_lo,
                     const int32_t* __restrict__ seg, int nseg,
                     const int32_t* __restrict__ grp_ptr,
                     const int32_t* __restrict__ grp_idx,
                     const TC* __restrict__ x, int64_t n_x,
                     TC* __restrict__ y, int64_t rows_out, int nblk, int gs,
                     int accumulate) {
  const int64_t pair = blockIdx.x;  // (step, block) = st * nblk + blk
  const int lane = threadIdx.x;
  const int64_t row = pair * kLanes + lane;
  const int64_t st = pair / nblk;
  const int gq = gs / 4;
  const TD* d = data + st * gs * kLanes + lane;
  const int32_t* bs = bands + st * bands_stride;
  const int32_t* sg = seg != nullptr ? seg + st * nseg : nullptr;
  const int64_t x0 = static_cast<int64_t>(band_lo[st]) * kLanes;

  TC acc = TC(0);
  const int k_end = grp_ptr[pair + 1];
  for (int k = grp_ptr[pair]; k < k_end; ++k) {
    const int g = grp_idx[k];
    TC gsum = TC(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = 4 * g + j;
      const TC v = to_compute(d[static_cast<int64_t>(q) * kLanes]);
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
      const int64_t col = x0 + static_cast<int64_t>(base) * kLanes + idx;
      const TC p = col >= 0 && col < n_x ? mul_rn(v, x[col]) : TC(0);
      gsum = j == 0 ? p : add_rn(gsum, p);
    }
    acc = add_rn(acc, gsum);
  }
  if (row < rows_out) y[row] = accumulate ? add_rn(y[row], acc) : acc;
}

template <typename TD, typename TC>
int launch(const void* data, const void* lanes, int idx_packed,
           const void* bands, int64_t bands_stride, const void* band_lo,
           const void* seg, int nseg, const void* grp_ptr,
           const void* grp_idx, const void* x, int64_t n_x, void* y,
           int64_t rows_out, int nsteps, int gs, int nblk, int accumulate,
           void* stream) {
  if (nsteps < 1 || nblk < 1 || gs < 4 || gs % 4 != 0 || rows_out < 1 ||
      (seg != nullptr && nseg < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t pairs = static_cast<int64_t>(nsteps) * nblk;
  const int64_t needed = (rows_out + kLanes - 1) / kLanes;
  if (needed < pairs) pairs = needed;
  bell_spmv_kernel<TD, TC>
      <<<static_cast<unsigned int>(pairs), kLanes, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TD*>(data),
          idx_packed ? static_cast<const uint32_t*>(lanes) : nullptr,
          idx_packed ? nullptr : static_cast<const uint8_t*>(lanes),
          static_cast<const int32_t*>(bands), bands_stride,
          static_cast<const int32_t*>(band_lo),
          static_cast<const int32_t*>(seg), nseg,
          static_cast<const int32_t*>(grp_ptr),
          static_cast<const int32_t*>(grp_idx), static_cast<const TC*>(x),
          n_x, static_cast<TC*>(y), rows_out, nblk, gs, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BELL_ENTRY(NAME, TD, TC)                                             \
  int NAME(const void* data, const void* lanes, int idx_packed,              \
           const void* bands, int64_t bands_stride, const void* band_lo,     \
           const void* seg, int nseg, const void* grp_ptr,                   \
           const void* grp_idx, const void* x, int64_t n_x, void* y,         \
           int64_t rows_out, int nsteps, int gs, int nblk, int accumulate,   \
           void* stream) {                                                   \
    return launch<TD, TC>(data, lanes, idx_packed, bands, bands_stride,      \
                          band_lo, seg, nseg, grp_ptr, grp_idx, x, n_x, y,   \
                          rows_out, nsteps, gs, nblk, accumulate, stream);   \
  }

extern "C" {

BELL_ENTRY(bell_spmv_f32, float, float)
BELL_ENTRY(bell_spmv_bf16, __nv_bfloat16, float)
BELL_ENTRY(bell_spmv_f64, double, double)

}  // extern "C"
