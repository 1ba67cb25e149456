// The card's read floor: f32 streams folded into 1024 bins, for NVIDIA
// Hopper (sm_90a).
//
//   out[q] = sum_k sum_i a_k[1024 i + q],   q < 1024,
//
// over one or two streams a_k of the same length, a multiple of 1024
// floats; out is (8, 128) to the caller.
//
// Replaces tools/probes/probe_stream_floor.py::blockspec_stream (its
// kernel, the pallas_call at :59) and ::ring_stream (:111), which ask how
// fast a TPU kernel reads HBM: (nsteps, rows, 128) f32 blocks, through
// BlockSpec double buffering or a manual DMA ring of depth 4 or 8, each
// block folded into an (8, 128) accumulator so the copies cannot be
// dropped.  One deliberate difference: the TPU kernel writes each grid
// step's fold over the same output block, so it returns the last block's
// fold; here every block's fold is summed.  On the card nothing else
// keeps the compiler from dropping the loads, and blocks run in no order,
// so "the last block" has no meaning.
//
// Bound: device-memory bytes, each stream read once (512 MB a call at the
// probe's size: 0.160 ms at the 3.35 TB/s an H100 SXM publishes).  The
// port's "achievable" rate until now was torch's copy_, half of whose
// bytes are writes; this kernel asks what a read-only stream reaches.
//
// Two modes:
//
//  * direct (the counterpart of the BlockSpec stream).  A block of 256
//    threads covers one row of 1024 floats, each thread four bins, read as
//    16-byte loads through the read-only path without allocating in L1
//    (ld.global.nc.L1::no_allocate.v4.f32).  The blocks walk the rows
//    grid-stride, so a thread keeps its bins; a thread issues the loads of
//    U rows (U in {1, 2, 4, 8}, of every stream) before it adds any.
//  * ring (the counterpart of the manual DMA ring).  Each block keeps a
//    ring of `depth` slots in shared memory, a slot holding `chunk` bytes
//    of every stream.  Thread 0 keeps depth - 1 slots in flight with
//    cp.async.bulk (the 1-D TMA copy), each slot's copies completing on its
//    mbarrier by bytes (csrc/tma_ring.cuh); all threads wait on the slot,
//    fold its rows from shared memory, and meet at a __syncthreads before
//    thread 0 refills it.  A block takes the chunks blockIdx.x, + gridDim.x,
//    ...; a chunk starts at a multiple of 1024 floats, so the bins stay
//    fixed, and the last one may be shorter (a multiple of 4 KB).
//
// Each thread sums its four bins in registers, then adds them into out
// with atomics (the wrapper zeroes it).  The probe's data are integers
// 0-7: every partial sum is an integer below 2^24 (at most 2^17 terms a
// bin at 512 MB), so every order of summation, atomics included, gives
// the plain version's bits.  The grid is the SMs times the blocks an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or `blocks`.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns a CUDA error code as an int (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kThreads = 256;   // a block covers one row of bins
constexpr int kRow = 1024;      // floats a row: the fold's bins
constexpr int kMaxDepth = 8;
constexpr int64_t kMaxRingBytes = 192 * 1024;

__device__ __forceinline__ float4 ld_stream4(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void add4(float (&acc)[4], const float4& v) {
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

__device__ __forceinline__ void flush(float (&acc)[4], float* out) {
#pragma unroll
  for (int q = 0; q < 4; ++q) atomicAdd(out + 4 * threadIdx.x + q, acc[q]);
}

template <int S, int U>
__global__ void __launch_bounds__(kThreads)
    stream_direct(const float* __restrict__ a0, const float* __restrict__ a1,
                  int64_t rows, float* __restrict__ out) {
  const int64_t stride = gridDim.x;
  const int lane4 = 4 * static_cast<int>(threadIdx.x);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t r0 = blockIdx.x; r0 < rows; r0 += U * stride) {
    float4 v[U][S];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = r0 + u * stride;
      if (r < rows) {
        v[u][0] = ld_stream4(a0 + r * kRow + lane4);
        if constexpr (S == 2) v[u][1] = ld_stream4(a1 + r * kRow + lane4);
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) v[u][s] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int s = 0; s < S; ++s) add4(acc, v[u][s]);
    }
  }
  flush(acc, out);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    stream_ring(const float* __restrict__ a0, const float* __restrict__ a1,
                int64_t len, int64_t chunk, int depth,
                float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxDepth];
  float* ring = reinterpret_cast<float*>(smem);   // slot s, stream k:
                                                  // ring + (s S + k) chunk
  const int64_t nchunks = (len + chunk - 1) / chunk;
  const int64_t mine =
      blockIdx.x < nchunks ? (nchunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) tma_ring::init(&full[s], 1);
    tma_ring::fence_init();
  }
  __syncthreads();

  // chunk j of this block into slot j mod depth
  auto issue = [&](int64_t j) {
    const int64_t first = (blockIdx.x + j * gridDim.x) * chunk;
    const int64_t n = len - first < chunk ? len - first : chunk;
    const uint32_t bytes = static_cast<uint32_t>(n * 4);
    const int slot = static_cast<int>(j % depth);
    tma_ring::arrive_expect(&full[slot], S * bytes);
    tma_ring::bulk_load(ring + (slot * S) * chunk, a0 + first, bytes,
                        &full[slot]);
    if constexpr (S == 2) {
      tma_ring::bulk_load(ring + (slot * S + 1) * chunk, a1 + first, bytes,
                          &full[slot]);
    }
  };

  if (threadIdx.x == 0) {
    for (int64_t j = 0; j < depth - 1 && j < mine; ++j) issue(j);
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t j = 0; j < mine; ++j) {
    // slot (j - 1) mod depth was released by every thread at the end of
    // the last pass
    if (threadIdx.x == 0 && j + depth - 1 < mine) issue(j + depth - 1);
    const int slot = static_cast<int>(j % depth);
    tma_ring::wait(&full[slot], static_cast<uint32_t>((j / depth) & 1));
    const int64_t first = (blockIdx.x + j * gridDim.x) * chunk;
    const int rows = static_cast<int>(
        (len - first < chunk ? len - first : chunk) / kRow);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4* buf =
          reinterpret_cast<const float4*>(ring + (slot * S + s) * chunk);
      for (int r = 0; r < rows; ++r) {
        add4(acc, buf[r * (kRow / 4) + threadIdx.x]);
      }
    }
    __syncthreads();
  }
  flush(acc, out);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The blocks of a full card: the SMs times the blocks an SM holds.
template <typename K>
int card_blocks(K kernel, size_t smem, int64_t* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  *blocks = static_cast<int64_t>(sms) * per_sm;
  return static_cast<int>(err);
}

template <int S, int U>
int launch_direct(const float* a0, const float* a1, int64_t rows,
                  int64_t blocks, float* out, cudaStream_t stream) {
  auto kernel = stream_direct<S, U>;
  if (blocks == 0) {
    const int err = card_blocks(kernel, 0, &blocks);
    if (err != 0) return err;
  }
  if (blocks > rows) blocks = rows;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      a0, a1, rows, out);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_direct_u(const float* a0, const float* a1, int64_t rows,
                    int64_t unroll, int64_t blocks, float* out,
                    cudaStream_t s) {
  switch (unroll) {
    case 1: return launch_direct<S, 1>(a0, a1, rows, blocks, out, s);
    case 2: return launch_direct<S, 2>(a0, a1, rows, blocks, out, s);
    case 4: return launch_direct<S, 4>(a0, a1, rows, blocks, out, s);
    case 8: return launch_direct<S, 8>(a0, a1, rows, blocks, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int S>
int launch_ring(const float* a0, const float* a1, int64_t len,
                int64_t chunk, int64_t depth, int64_t blocks, float* out,
                cudaStream_t stream) {
  auto kernel = stream_ring<S>;
  const size_t smem = static_cast<size_t>(depth * S * chunk * 4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) {
    const int e = card_blocks(kernel, smem, &blocks);
    if (e != 0) return e;
  }
  const int64_t nchunks = (len + chunk - 1) / chunk;
  if (blocks > nchunks) blocks = nchunks;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      a0, a1, len, chunk, static_cast<int>(depth), out);
  return static_cast<int>(cudaGetLastError());
}

// len floats a stream; a1 is read only when nstreams is 2
bool streams_ok(const void* a0, const void* a1, int64_t nstreams,
                int64_t len) {
  return (nstreams == 1 || nstreams == 2) && len >= kRow &&
         len % kRow == 0 && aligned16(a0) &&
         (nstreams == 1 || aligned16(a1));
}

}  // namespace

extern "C" {

// blocks: 0 for the card's full occupancy, else the grid (at most the
// rows of 1024 floats)
int probe_stream_direct(const void* a0, const void* a1, int64_t nstreams,
                        int64_t len, int64_t unroll, int64_t blocks,
                        void* out, void* stream) {
  if (!streams_ok(a0, a1, nstreams, len) || blocks < 0 ||
      blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p0 = static_cast<const float*>(a0);
  const float* p1 = static_cast<const float*>(a1);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = len / kRow;
  if (nstreams == 1) {
    return launch_direct_u<1>(p0, p1, rows, unroll, blocks, o, s);
  }
  return launch_direct_u<2>(p0, p1, rows, unroll, blocks, o, s);
}

// chunk: bytes a stream a slot, a multiple of 4096; nstreams x depth x
// chunk at most 192 KB of shared memory
int probe_stream_ring(const void* a0, const void* a1, int64_t nstreams,
                      int64_t len, int64_t chunk_bytes, int64_t depth,
                      int64_t blocks, void* out, void* stream) {
  if (!streams_ok(a0, a1, nstreams, len) || blocks < 0 ||
      blocks > INT32_MAX || depth < 2 ||
      depth > kMaxDepth || chunk_bytes < 4 * kRow ||
      chunk_bytes % (4 * kRow) != 0 ||
      nstreams * depth * chunk_bytes > kMaxRingBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p0 = static_cast<const float*>(a0);
  const float* p1 = static_cast<const float*>(a1);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t chunk = chunk_bytes / 4;
  if (nstreams == 1) {
    return launch_ring<1>(p0, p1, len, chunk, depth, blocks, o, s);
  }
  return launch_ring<2>(p0, p1, len, chunk, depth, blocks, o, s);
}

}  // extern "C"
