// DIA sparse matrix-vector product y = A x with the diagonals fed through
// a TMA ring in shared memory, for NVIDIA Hopper (sm_90a).
//
//   y[i] = sum_k data[k, i] * x[i + offsets[k]],   k ascending,
//
// over the unpadded DIA container of pykrylov_tpu_torch.sparse.formats
// (data (ndiag, m) row-major, f32; x f32 of n entries; ndiag <= 4096), the
// function of kernels.dia_matvec_plain: a term whose column lies outside
// [0, n) is skipped, products and sums are rounded one by one
// (__fmul_rn/__fadd_rn) in container order from 0, so the two agree bit
// for bit.
//
// Replaces tools/probes/probe_dia_manual_dma.py::_dia_kernel_mdma (the
// pallas_call at :137), which streams a TPU block's diagonals one at a
// time through a 2-slot VMEM ring by manual DMA (and x through a 4-slot
// ring), so that a block of 262144 rows fits.  Here the diagonals arrive
// the same way, one tile of one diagonal a slot, but by cp.async.bulk (the
// 1-D TMA copy) into shared memory, completing on the slot's mbarrier by
// bytes (csrc/tma_ring.cuh): the copy engine moves the diagonal stream and
// the threads spend no registers on it.  The card's built SpMV
// (csrc/dia_spmv.cu) loads its diagonals into registers ahead of their
// products instead, and found that registers, not loads, set how far ahead
// it can go (32 terms ahead ran bf16 1.4x slower than 8).  x is read
// through the read-only path, as there, and reused from L1 and L2.
//
// Bound: device-memory bytes, (ndiag + 2) m 4 at best: 498 MB, 0.149 ms
// at the 3.35 TB/s an H100 SXM publishes, for the 3-D Poisson matrix at
// n = 240 (13.8M rows, 7 diagonals).
//
// The design.  A block is 8 consumer warps and one producer warp.  The
// rows are cut into tiles of `tile` rows (a multiple of 256); a block
// computes the tiles blockIdx.x, + gridDim.x, ... in turn, each consumer
// thread R = tile / 256 rows of a tile (rows th, th + 256, ...: a warp
// reads 32 neighbouring values of a slot and of x).  The block's stream of
// diagonal tiles is its tiles times the diagonals, position
// g = j ndiag + k for its tile j and diagonal k, and position g lives in
// slot g mod depth, its use g / depth completing the slot's phase of
// parity (g / depth) & 1.  Positions are counted over the block's whole
// stream, not per tile: with an odd number of diagonals a count that
// restarted at each tile would put the producer and the consumers on
// different slots at the tile's edge (the TPU probe's first run returned
// wrong values from exactly that).  Lane 0 of the producer warp waits
// until the consumers released a slot (its "empty" mbarrier, one arrival a
// consumer warp), arrives on the slot's "full" mbarrier with the bytes to
// expect and issues the copy; it runs up to `depth` positions ahead, so
// the copy of the diagonal depth - 1 positions ahead is in flight before
// diagonal k's products.  The consumers wait on "full", add their
// products, and release the slot.  A tile whose rows have every term in
// range ([lo, hi) from the launcher) runs without range checks.  The last
// tile may be ragged: its copies are its rows' bytes, a multiple of 16
// since 4 divides m.
//
// The offsets travel by value as int32 (16 KB of parameters, as
// csrc/dia_spmv.cu passes them past 64 diagonals); an offset outside
// (-m, n) has no term in the matrix and is clamped to -m or n, so m and n
// must fit in 31 bits.  The copies need data 16-byte aligned and 4 | m.
//
// The entry point launches on the given stream, does not synchronise, and
// returns a CUDA error code as an int (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kConsumers = 256;             // threads computing rows
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kWarps = kConsumers / 32;
constexpr int kWideDiags = 4096;
constexpr int kMaxDepth = 8;
constexpr int64_t kMaxRingBytes = 192 * 1024;

struct WideOffsets {
  int ndiag;
  int32_t off[kWideDiags];  // diagonal offsets, container order, clamped
};

// One diagonal's products for this thread's R rows of a tile; `d` is the
// slot, `i0` the tile's first row.
template <bool CHECK, int R>
__device__ __forceinline__ void products(float (&acc)[R],
                                         const float* __restrict__ d,
                                         const float* __restrict__ x,
                                         int64_t i0, int rows, int64_t off,
                                         int64_t n) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = static_cast<int>(threadIdx.x) + r * kConsumers;
    if (row < rows) {
      const int64_t col = i0 + row + off;
      if (!CHECK || (col >= 0 && col < n)) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(d[row], __ldg(x + col)));
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    dia_ring_kernel(const float* __restrict__ data,
                    const __grid_constant__ WideOffsets o,
                    const float* __restrict__ x, float* __restrict__ y,
                    int64_t m, int64_t n, int64_t lo, int64_t hi,
                    int depth) {
  constexpr int kTile = R * kConsumers;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxDepth];
  __shared__ __align__(8) uint64_t empty[kMaxDepth];
  float* ring = reinterpret_cast<float*>(smem);   // slot s: ring + s kTile
  const int ndiag = o.ndiag;
  const int64_t tiles = (m + kTile - 1) / kTile;
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      tma_ring::init(&full[s], 1);
      tma_ring::init(&empty[s], kWarps);
    }
    tma_ring::fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp: lane 0 walks the block's stream of positions
    if (threadIdx.x == kConsumers) {
      const int64_t positions = mine * ndiag;
      for (int64_t g = 0; g < positions; ++g) {
        const int slot = static_cast<int>(g % depth);
        const int64_t use = g / depth;
        if (use > 0) {
          tma_ring::wait(&empty[slot], static_cast<uint32_t>((use - 1) & 1));
        }
        const int64_t j = g / ndiag;
        const int k = static_cast<int>(g - j * ndiag);
        const int64_t i0 = (blockIdx.x + j * gridDim.x) * kTile;
        const int rows = static_cast<int>(m - i0 < kTile ? m - i0 : kTile);
        const uint32_t bytes = static_cast<uint32_t>(rows) * 4;
        tma_ring::arrive_expect(&full[slot], bytes);
        tma_ring::bulk_load(ring + slot * kTile, data + k * m + i0, bytes,
                            &full[slot]);
      }
    }
    return;   // no __syncthreads follows
  }

  const int lane = static_cast<int>(threadIdx.x) % 32;
  int64_t g = 0;
  for (int64_t j = 0; j < mine; ++j) {
    const int64_t i0 = (blockIdx.x + j * gridDim.x) * kTile;
    const int rows = static_cast<int>(m - i0 < kTile ? m - i0 : kTile);
    const bool interior = i0 >= lo && i0 + rows <= hi;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = 0; k < ndiag; ++k, ++g) {
      const int slot = static_cast<int>(g % depth);
      tma_ring::wait(&full[slot], static_cast<uint32_t>((g / depth) & 1));
      const float* d = ring + slot * kTile;
      if (interior) {
        products<false, R>(acc, d, x, i0, rows, o.off[k], n);
      } else {
        products<true, R>(acc, d, x, i0, rows, o.off[k], n);
      }
      __syncwarp();
      if (lane == 0) tma_ring::arrive(&empty[slot]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = static_cast<int>(threadIdx.x) + r * kConsumers;
      if (row < rows) y[i0 + row] = acc[r];
    }
  }
}

template <int R>
int launch(const float* data, const WideOffsets& o, const float* x,
           float* y, int64_t m, int64_t n, int64_t lo, int64_t hi,
           int64_t depth, cudaStream_t stream) {
  auto kernel = dia_ring_kernel<R>;
  constexpr int64_t kTile = int64_t{R} * kConsumers;
  const size_t smem = static_cast<size_t>(depth * kTile * 4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (m + kTile - 1) / kTile;
  int64_t blocks = static_cast<int64_t>(sms) * per_sm;
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      data, o, x, y, m, n, lo, hi, static_cast<int>(depth));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// offsets: ndiag int64; tile rows a tile (256, 512, 1024, 2048 or 4096);
// depth slots of the ring (2-8), depth x tile x 4 bytes at most 192 KB;
// [lo, hi): the rows whose every term lies in [0, n) (lo == hi: none)
int probe_dia_ring_f32(const void* data, const void* offsets, int64_t ndiag,
                       const void* x, void* y, int64_t m, int64_t n,
                       int64_t lo, int64_t hi, int64_t tile, int64_t depth,
                       void* stream) {
  if (ndiag < 0 || ndiag > kWideDiags || m < 1 || n < 0 ||
      m > INT32_MAX || n > INT32_MAX || m % 4 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 || depth < 2 ||
      depth > kMaxDepth || depth * tile * 4 > kMaxRingBytes || lo < 0 ||
      lo > hi || hi > m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* src = static_cast<const int64_t*>(offsets);
  WideOffsets o;
  o.ndiag = static_cast<int>(ndiag);
  for (int64_t k = 0; k < ndiag; ++k) {
    int64_t off = src[k];
    // an interior row reads x[i + off] unchecked
    if (lo < hi && (lo + off < 0 || hi + off > n)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    off = off < -m ? -m : (off > n ? n : off);
    o.off[k] = static_cast<int32_t>(off);
  }
  const float* d = static_cast<const float*>(data);
  const float* xs = static_cast<const float*>(x);
  float* ys = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 256: return launch<1>(d, o, xs, ys, m, n, lo, hi, depth, s);
    case 512: return launch<2>(d, o, xs, ys, m, n, lo, hi, depth, s);
    case 1024: return launch<4>(d, o, xs, ys, m, n, lo, hi, depth, s);
    case 2048: return launch<8>(d, o, xs, ys, m, n, lo, hi, depth, s);
    case 4096: return launch<16>(d, o, xs, ys, m, n, lo, hi, depth, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
