// A one-hot select on the tensor cores of NVIDIA Hopper (sm_90a):
// out = oh @ w for an (GS, NB) one-hot oh and an (NB, L) f32 w, in one of
// two transports.
//
// Replaces tools/probes/probe_int8_mxu.py::k_int8 and ::k_bf16 (the
// pallas_call at :57), which asked whether the TPU's matrix unit can move
// f32 values exactly: as four int8 bit planes (k_int8) or as three bf16
// pieces (k_bf16).  Here (csrc/onehot_mma.cuh):
//
//   int8     four u8 byte planes of w's bits on mma.sync.m16n8k32 with s32
//            sums: out[r] = w[argmax(oh[r])], bit for bit, for every
//            pattern (-0, subnormals, inf, NaN payloads)
//   bf16x3   three bf16 pieces on m16n8k16, each product summed in f32,
//            out = (t1 + t2) + t3: exact for finite normal w; -0 comes
//            back +0, and a column of w that holds inf or NaN is NaN in
//            every row (0 * inf)
//
// A block of 4 warps takes 64 rows and 32 columns.  It first copies its
// 32 columns of w into shared memory (16-byte loads, all issued before
// any store), while each warp finds the argmax (the first of the largest
// bytes) of each of its 16 rows of oh, its byte loads for all 16 rows and
// 4 columns a lane in flight together.  The indices give the A fragments,
// built in registers, so the products are those of oh itself wherever oh
// has one 1 a row; each warp then runs every k-chunk of NB for its 4
// n-tiles of 8 columns at once, the B fragments read from shared memory.
//
// Bound: bytes (oh once, w once, out once: 0.9 MB at GS, NB, L = 1024,
// 256, 128) against 4 int8 or 3 bf16 dense products of 2 GS NB L
// operations on the tensor cores; the bytes bound it.  Shared memory
// (NB x 144 bytes) bounds NB at 1536.
//
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "onehot_mma.cuh"

namespace {

using namespace onehot_mma;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // rows of oh a block
constexpr int kCols = 32;            // columns of w a block: 4 n-tiles
constexpr int kWStride = 36;         // floats a row of the block's w: the
                                     // bf16 B rows 2t fall on banks 8t + g
constexpr int kLoads = 8;            // 16-byte loads of w in flight
constexpr int kNbMax = 1536;         // NB x 144 bytes of shared memory

enum Mode { kInt8 = 0, kBf16x3 = 1 };

template <int M>
__global__ void __launch_bounds__(kThreads)
    onehot_select_kernel(const uint8_t* __restrict__ oh,
                         const float* __restrict__ w,
                         float* __restrict__ out, int gs, int nb, int l) {
  extern __shared__ __align__(16) float ws[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = frag_g(), t = frag_t();
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows + 16 * warp;
  const int n_base = blockIdx.y * kCols;

  // the block's 32 columns of w
  const bool vec = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int quads = nb * (kCols / 4);
  for (int i0 = threadIdx.x; i0 < quads; i0 += kThreads * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      const float* src = w + static_cast<int64_t>(i / 8) * l + n_base +
                         4 * (i % 8);
      if (i >= quads) {
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (vec) {
        v[u] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        v[u] = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2),
                           __ldg(src + 3));
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      if (i < quads) {
        *reinterpret_cast<float4*>(ws + (i / 8) * kWStride + 4 * (i % 8)) =
            v[u];
      }
    }
  }

  // each row's argmax: (byte << 16) | (0xFFFF - column), the largest byte
  // first, then the lowest column
  uint32_t best[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) best[i] = 0;
#pragma unroll 4
  for (int c = lane; c < nb; c += 32) {
    uint32_t b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = __ldg(oh + (r0 + i) * nb + c);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t key =
          (b[i] << 16) | (0xFFFFu - static_cast<uint32_t>(c));
      best[i] = key > best[i] ? key : best[i];
    }
  }
  int lo = 0, hi = 0;   // the indices of rows g and g + 8 of the tile
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int k = static_cast<int>(
        0xFFFFu - (__reduce_max_sync(0xFFFFFFFFu, best[i]) & 0xFFFFu));
    lo = i == g ? k : lo;
    hi = i == g + 8 ? k : hi;
  }
  __syncthreads();

  float y[kCols / 8][4];
  if constexpr (M == kInt8) {
    int d[kCols / 8][4][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < nb; k0 += kKU8) {
      uint32_t a[4];
      a_rows_u8(a, lo, hi, k0);
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        u8x4(d[nt], a, [&](int k, int n) {
          return ws[(k0 + k) * kWStride + 8 * nt + n];
        });
      }
    }
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] = join4(d[nt], e);
  } else {
    float d[kCols / 8][3][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < nb; k0 += kKBf16) {
      uint32_t a[4];
      a_rows_bf16(a, lo, hi, k0);
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        bf16x3(d[nt], a, [&](int k, int n) {
          return ws[(k0 + k) * kWStride + 8 * nt + n];
        });
      }
    }
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] = join3(d[nt], e);
  }
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
    float* o = out + (r0 + g) * l + n_base + 8 * nt + 2 * t;
    o[0] = y[nt][0];
    o[1] = y[nt][1];
    o[8 * l] = y[nt][2];
    o[8 * l + 1] = y[nt][3];
  }
}

template <int M>
int launch(const uint8_t* oh, const float* w, float* out, int gs, int nb,
           int l, cudaStream_t s) {
  const int bytes = nb * kWStride * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      onehot_select_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(gs / kRows),
                  static_cast<unsigned>(l / kCols));
  onehot_select_kernel<M><<<grid, kThreads, bytes, s>>>(oh, w, out, gs, nb,
                                                        l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode: 0 int8, 1 bf16x3.  gs % 64 == 0, nb % 32 == 0 (nb <= 1536),
// l % 32 == 0.
int probe_onehot_select(const void* oh, const void* w, void* out,
                        int64_t gs, int64_t nb, int64_t l, int64_t mode,
                        void* stream) {
  if (gs < kRows || gs % kRows || nb < 32 || nb % 32 || nb > kNbMax ||
      l < kCols || l % kCols || gs / kRows > INT32_MAX || l / kCols > 65535 ||
      gs > INT32_MAX || l > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* o = static_cast<const uint8_t*>(oh);
  const auto* ws = static_cast<const float*>(w);
  auto* y = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(gs), n = static_cast<int>(nb),
            c = static_cast<int>(l);
  switch (mode) {
    case kInt8: return launch<kInt8>(o, ws, y, g, n, c, s);
    case kBf16x3: return launch<kBf16x3>(o, ws, y, g, n, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
