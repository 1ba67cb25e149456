// One product over a window-1 BELL container with the x window staged and
// the group sums scattered on the tensor cores of NVIDIA Hopper (sm_90a),
// or by loads and adds: the probe of whether the matrix unit can do the
// BELL kernel's non-matrix work more cheaply than the vector unit.
//
// Replaces tools/probes/probe_ablate_r3b.py::make_kernel (the pallas_call
// at :172), whose variants moved the x window's staging and the scatter of
// group sums into output blocks onto the TPU's matrix unit.  Each
// combination is a defined function (probes/bell_mma.py states it and
// holds its plain version): for slot row q of step st,
//
//   staging   xs[q] = row bands[st, q] of the step's window, the 128-column
//             bands band_lo[st] .. band_lo[st] + kb of x (columns at or
//             past n_x read 0; with nseg = 4, kb = max(8, nb / 4) and a row
//             whose band is kb or more selects 0), through a one-hot
//             product in 3 bf16 pieces ("bf16", m16n8k16), in 3 tf32
//             pieces ("f32", m16n8k8), or read straight ("load")
//   product   prod[q, l] = f32(data[st, q, l]) * xs[q, idx[q, l]]
//   fold      group sum p (storage order, [even | odd] natural groups):
//             "tile"    ((r0 + r1) + r2) + r3 over the rows of its group
//             "halves"  (prod[p] + prod[p + GS/2]) + (prod[p + GS/4] +
//                       prod[p + 3 GS/4]), the probe's pairing
//   scatter   y[st, blocks[st, p]] gets group sum p: through a one-hot
//             product in 3 bf16 or 3 tf32 pieces ("bf16", "f32"; the
//             tensor cores sum a block's groups in f32 in their own order),
//             or added in ascending natural group order from 0 ("add")
//
// every product and add rounded on its own (__fmul_rn, __fadd_rn).  With a
// finite window each one-hot staging is exact, so the "add" combinations
// equal their plain version bit for bit; an mma scatter is within a few
// f32 roundings of a block's sum of |group sums|.
//
// Layout.  A block of 8 warps takes one step and 16 of its output blocks
// (the scatter's m-tile), so no sum crosses a block; the grid is
// (ceil(nblk / 16), nsteps).  It loads the step's window into shared
// memory by 16-byte loads, 8 in flight a thread (kb x 512 bytes as f32;
// "bf16" staging stores each entry's three pieces instead, split once,
// whose B fragments ldmatrix.trans reads two n-tiles at a time), then
// walks its blocks' groups (the container's map grp_ptr/grp_idx,
// ascending) in rounds of 64.  A round first finds its 256 slot rows, a
// thread each (rows 4g .. 4g + 3 of a group, or p + {0, 1, 2, 3} GS/4 for
// "halves"; their bands and lanes words).  Each warp then takes 4 groups
// (16 rows) at a time: it stages them with one-hot A fragments built from
// their bands (csrc/onehot_mma.cuh), 4 n-tiles at once, into a 16 x 128
// tile in shared memory, then selects, multiplies and folds, a thread 4
// lanes of 32 apart, every row's loads issued together, into the round's
// buffer of group sums.  The scatter adds the round into 16 x 128 block
// sums held in registers, by adds (a thread a lane and 8 blocks) or by
// one-hot products (a warp 2 n-tiles, each piece's sum accumulated across
// rounds).
//
// Bound: bytes (values, packed indices, bands, the step's group map, the x
// windows and y, each once: about 108 MB at the probe's 91 steps of 1696
// rows) against the staging products (2 GS kb 128 a step and piece) and
// the scatter products on the tensor cores; the bytes bound it at the
// probe's size.  Shared memory bounds kb: the wrapper refuses a window
// past what a block can hold (144 bands with "bf16" staging, 224 with
// "f32", 352 loaded).
//
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "onehot_mma.cuh"

namespace {

using namespace onehot_mma;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBlocks = 16;   // output blocks a block: one m-tile
constexpr int kRound = 64;        // group sums a round holds
constexpr int kRoundRows = 4 * kRound;   // their slot rows: one a thread
constexpr int kStride = 132;      // floats a row of the tiles and sums
constexpr int kWinStride = 136;   // entries a window row (f32, or bf16
                                  // pieces): the tf32 B rows t, t + 4 fall
                                  // on banks 8t + g, and ldmatrix's 8
                                  // rows of 16 bytes on banks 4r ..
                                  // 4r + 3, without conflict
constexpr int kNTiles = 4;        // n-tiles a warp stages at once
constexpr int kLoads = 8;         // 16-byte window loads in flight a thread
constexpr int kLanes = 128;
constexpr int kSmemMax = 232448;  // a block's shared memory on an H100

static_assert(kRoundRows == kThreads, "a round's rows: one a thread");

enum Stage { kStageBf16 = 0, kStageF32 = 1, kStageLoad = 2 };
enum Scatter { kScatterBf16 = 0, kScatterF32 = 1, kScatterAdd = 2 };

struct Params {
  const void* data;
  const int32_t* lanes;
  const int32_t* bands;
  const int32_t* blocks;
  const int32_t* band_lo;
  const int32_t* grp_ptr;
  const int32_t* grp_idx;
  const float* x;
  float* y;
  int64_t n_x;
  int gs, kb, nblk, halves, values_bf16;
};

__host__ __device__ constexpr int window_rows(int kb) {
  return (kb + kKBf16 - 1) / kKBf16 * kKBf16;
}

// Bytes of the window: the three bf16 pieces of each entry, a [k][n]
// array a piece ("bf16" staging), or the f32 entries.
__host__ __device__ constexpr int64_t window_bytes(int kb, int stage) {
  return (stage == kStageBf16 ? 6LL : 4LL) * window_rows(kb) * kWinStride;
}

__host__ __device__ constexpr int64_t smem_bytes(int kb, int stage) {
  return window_bytes(kb, stage) +
         4LL * kStride * ((stage != kStageLoad ? kWarps * 16 : 0) + kRound) +
         4LL * (3 * kRoundRows + kRound + kTileBlocks + 1);
}

__device__ __forceinline__ float value_at(const Params& P, int64_t i) {
  if (P.values_bf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(P.data)[i]);
  }
  return static_cast<const float*>(P.data)[i];
}

// Entries 4c .. 4c + 3 of window row k (zero at or past kb or n_x).
__device__ __forceinline__ float4 window_quad(const Params& P, int64_t col0,
                                              int k, int c, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k >= P.kb) return v;
  const int64_t col = col0 + static_cast<int64_t>(k) * kLanes + 4 * c;
  if (vec && col + 3 < P.n_x) {
    return __ldg(reinterpret_cast<const float4*>(P.x + col));
  }
  v.x = col < P.n_x ? __ldg(P.x + col) : 0.f;
  v.y = col + 1 < P.n_x ? __ldg(P.x + col + 1) : 0.f;
  v.z = col + 2 < P.n_x ? __ldg(P.x + col + 2) : 0.f;
  v.w = col + 3 < P.n_x ? __ldg(P.x + col + 3) : 0.f;
  return v;
}

// "load" takes half the shared memory: two blocks to an SM
template <int ST, int SC>
__global__ void __launch_bounds__(kThreads, ST == kStageLoad ? 2 : 1)
    bell_mma_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStaged = ST != kStageLoad;
  const int kpad = window_rows(P.kb);
  float* win = reinterpret_cast<float*>(smem);   // f32 rows, or pieces
  float* tiles = reinterpret_cast<float*>(smem + window_bytes(P.kb, ST));
  float* ps = tiles + (kStaged ? kWarps * 16 * kStride : 0);
  int* rrow = reinterpret_cast<int*>(ps + kRound * kStride);
  int* rband = rrow + kRoundRows;
  int* rword = rband + kRoundRows;
  int* eblk = rword + kRoundRows;
  int* bptr = eblk + kRound;

  const int st = blockIdx.y;
  const int b0 = blockIdx.x * kTileBlocks;
  const int nbl = min(kTileBlocks, P.nblk - b0);
  const int gq = P.gs / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = frag_g(), t = frag_t();

  // the step's window, zero past n_x and in the rows past kb: 16-byte
  // loads, kLoads of them in flight a thread; "bf16" staging splits each
  // entry into its pieces here, once
  {
    const int64_t col0 = static_cast<int64_t>(kLanes) * P.band_lo[st];
    const bool vec = (reinterpret_cast<uintptr_t>(P.x) & 15) == 0;
    const int quads = kpad * (kLanes / 4);
    for (int i0 = threadIdx.x; i0 < quads; i0 += kThreads * kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < quads ? window_quad(P, col0, i / 32, i % 32, vec)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= quads) break;
        const int k = i / 32, c = 4 * (i % 32);
        if constexpr (ST == kStageBf16) {
          auto* half = reinterpret_cast<uint16_t*>(win);
          const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t p[3];
            split_bf16(e[q], p);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              half[(j * kpad + k) * kWinStride + c + q] =
                  static_cast<uint16_t>(p[j]);
            }
          }
        } else {
          *reinterpret_cast<float4*>(win + k * kWinStride + c) = v[u];
        }
      }
    }
  }
  if (threadIdx.x <= kTileBlocks) {
    const int b = b0 + min(static_cast<int>(threadIdx.x), nbl);
    bptr[threadIdx.x] = P.grp_ptr[static_cast<int64_t>(st) * P.nblk + b];
  }
  __syncthreads();
  const int e0 = bptr[0];
  const int ng = bptr[nbl] - e0;

  float acc[8];          // "add": lane threadIdx % 128 of blocks 2i + hi
  float yd[2][3][4];     // mma: n-tiles 2 warp + j, a sum a piece
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) yd[j][i][e] = 0.f;

  float* tile = tiles + warp * 16 * kStride;
  const int64_t step_rows = static_cast<int64_t>(st) * P.gs;
  const int32_t* step_lanes = P.lanes + static_cast<int64_t>(st) * gq *
                                            kLanes;
  const auto* wp = reinterpret_cast<const uint16_t*>(win);

  for (int r0 = 0; r0 < ng; r0 += kRound) {
    const int nr = min(kRound, ng - r0);
    // the round's slot rows, one a thread: row 4q + k is row k of group q
    {
      const int r = threadIdx.x, q = r / 4, k = r % 4;
      int row = -1, band = -1, word = 0, blk = -1;
      if (q < nr) {
        const int gnat = P.grp_idx[e0 + r0 + q];
        const int p = (gnat & 1) ? gq / 2 + (gnat >> 1) : gnat >> 1;
        row = P.halves ? p + k * gq : 4 * gnat + k;
        band = P.bands[step_rows + row];
        band = band < P.kb ? band : -1;
        const int byte = (row >= gq) + (row >= 2 * gq) + (row >= 3 * gq);
        word = (row - byte * gq) * 4 + byte;   // the lanes word, its byte
        if (k == 0) blk = P.blocks[static_cast<int64_t>(st) * gq + p] - b0;
      }
      rrow[r] = row;
      rband[r] = band;
      rword[r] = word;
      if (k == 0) eblk[q] = blk;
    }
    __syncthreads();
    // a. the round's group sums, 4 groups (16 slot rows) a warp at a time;
    // the sums past nr, up to the next 16, are 0 (the mma scatter reads
    // them)
    const int nchunks = (nr + 15) / 16 * 4;
    for (int c = warp; c < nchunks; c += kWarps) {
      if (4 * c >= nr) {
        for (int i = lane; i < 4 * kLanes; i += 32) {
          ps[(4 * c + i / kLanes) * kStride + i % kLanes] = 0.f;
        }
        continue;
      }
      const int* crow = rrow + 16 * c;
      const int* cband = rband + 16 * c;
      const int* cword = rword + 16 * c;
      if constexpr (kStaged) {
        const int lo = cband[g], hi = cband[g + 8];
#pragma unroll 1
        for (int n4 = 0; n4 < kLanes / 8; n4 += kNTiles) {
          float d[kNTiles][3][4] = {};
          if constexpr (ST == kStageBf16) {
#pragma unroll 2
            for (int k0 = 0; k0 < kpad; k0 += kKBf16) {
              uint32_t a[4];
              a_rows_bf16(a, lo, hi, k0);
#pragma unroll
              for (int j = 0; j < kNTiles; j += 2) {
                // row k0 + lane % 16 of n-tile n4 + j + lane / 16
                const uint16_t* w = wp + (k0 + (lane & 15)) * kWinStride +
                                    8 * (n4 + j + (lane >> 4));
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                  uint32_t b[4];
                  ldsm_x4_trans(b, w + i * kpad * kWinStride);
                  mma_bf16(d[j][i], a, b[0], b[1]);
                  mma_bf16(d[j + 1][i], a, b[2], b[3]);
                }
              }
            }
          } else {
#pragma unroll 2
            for (int k0 = 0; k0 < kpad; k0 += kKTf32) {
              uint32_t a[4];
              a_rows_tf32(a, lo, hi, k0);
#pragma unroll
              for (int j = 0; j < kNTiles; ++j) {
                tf32x3(d[j], a, [&](int k, int n) {
                  return win[(k0 + k) * kWinStride + 8 * (n4 + j) + n];
                });
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kNTiles; ++j) {
            float* o = tile + 8 * (n4 + j) + 2 * t;
            o[g * kStride] = join3(d[j], 0);
            o[g * kStride + 1] = join3(d[j], 1);
            o[(g + 8) * kStride] = join3(d[j], 2);
            o[(g + 8) * kStride + 1] = join3(d[j], 3);
          }
        }
        __syncwarp();
      }
      // select, multiply, fold: lanes lane + 32 j of the 4 groups
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = lane + 32 * j;
        float pr[16];
        // every row's loads unconditional (a row past the round reads row
        // 0 and is dropped), so that all of them are in flight at once
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int row = crow[i];
          const int w = cword[i];
          const int idx = (__ldg(step_lanes + (w >> 2) * kLanes + l) >>
                           (8 * (w & 3))) & 255;
          const float d =
              value_at(P, (step_rows + max(row, 0)) * kLanes + l);
          float xs;
          if constexpr (kStaged) {
            xs = tile[i * kStride + idx];
          } else {
            const int band = cband[i];
            xs = band >= 0 ? win[band * kWinStride + idx] : 0.f;
          }
          pr[i] = row >= 0 ? __fmul_rn(d, xs) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* r = pr + 4 * q;
          const float s =
              P.halves ? __fadd_rn(__fadd_rn(r[0], r[2]),
                                   __fadd_rn(r[1], r[3]))
                       : __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[1]), r[2]),
                                   r[3]);
          ps[(4 * c + q) * kStride + l] = 4 * c + q < nr ? s : 0.f;
        }
      }
      __syncwarp();
    }
    __syncthreads();
    // b. the round into the block sums
    if constexpr (SC == kScatterAdd) {
      const int l = threadIdx.x % kLanes;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int bi = static_cast<int>(threadIdx.x / kLanes) + 2 * i;
        if (bi < nbl) {
          const int lo = max(bptr[bi] - e0 - r0, 0);
          const int hi = min(bptr[bi + 1] - e0 - r0, nr);
          for (int q = lo; q < hi; ++q) {
            acc[i] = __fadd_rn(acc[i], ps[q * kStride + l]);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * warp + j;
#pragma unroll 1
        for (int k0 = 0; k0 < nr; k0 += (SC == kScatterBf16 ? kKBf16
                                                             : kKTf32)) {
          uint32_t a[4];
          const auto at = [&](int k, int n) {
            return ps[(k0 + k) * kStride + 8 * nt + n];
          };
          if constexpr (SC == kScatterBf16) {
            a_cols_bf16(a, eblk + k0);
            bf16x3(yd[j], a, at);
          } else {
            a_cols_tf32(a, eblk + k0);
            tf32x3(yd[j], a, at);
          }
        }
      }
    }
    __syncthreads();
  }

  float* yst = P.y + (static_cast<int64_t>(st) * P.nblk + b0) * kLanes;
  if constexpr (SC == kScatterAdd) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int bi = static_cast<int>(threadIdx.x / kLanes) + 2 * i;
      if (bi < nbl) yst[bi * kLanes + threadIdx.x % kLanes] = acc[i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = yst + 8 * (2 * warp + j) + 2 * t;
      if (g < nbl) {
        o[g * kLanes] = join3(yd[j], 0);
        o[g * kLanes + 1] = join3(yd[j], 1);
      }
      if (g + 8 < nbl) {
        o[(g + 8) * kLanes] = join3(yd[j], 2);
        o[(g + 8) * kLanes + 1] = join3(yd[j], 3);
      }
    }
  }
}

template <int ST, int SC>
int launch(const Params& P, int nsteps, cudaStream_t stream) {
  const int64_t bytes = smem_bytes(P.kb, ST);
  cudaError_t err = cudaFuncSetAttribute(
      bell_mma_kernel<ST, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P.nblk + kTileBlocks - 1) / kTileBlocks, nsteps);
  bell_mma_kernel<ST, SC><<<grid, kThreads, bytes, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int ST>
int launch_scatter(const Params& P, int nsteps, int64_t scatter,
                   cudaStream_t s) {
  switch (scatter) {
    case kScatterBf16: return launch<ST, kScatterBf16>(P, nsteps, s);
    case kScatterF32: return launch<ST, kScatterF32>(P, nsteps, s);
    case kScatterAdd: return launch<ST, kScatterAdd>(P, nsteps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory a block takes for kb window rows and the stage (0 bf16,
// 1 f32, 2 load).
int64_t probe_bell_mma_smem(int64_t kb, int64_t stage) {
  return smem_bytes(static_cast<int>(kb), static_cast<int>(stage));
}

int64_t probe_bell_mma_smem_max() { return kSmemMax; }

// stage: 0 bf16, 1 f32 (tf32 pieces), 2 load; scatter: 0 bf16, 1 f32,
// 2 add; halves: the fold (0 tile, 1 halves); values_bf16: data is bf16
// (else f32).  gs % 32 == 0; 1 <= kb <= 65535 with its shared memory at
// most kSmemMax.
int probe_bell_step_mma(const void* data, int64_t values_bf16,
                        const void* lanes, const void* bands,
                        const void* blocks, const void* band_lo,
                        const void* grp_ptr, const void* grp_idx,
                        const void* x, int64_t n_x, void* y, int64_t nsteps,
                        int64_t gs, int64_t kb, int64_t nblk, int64_t halves,
                        int64_t stage, int64_t scatter, void* stream) {
  if (nsteps < 1 || nsteps > 65535 || gs < 32 || gs % 32 || gs > INT32_MAX ||
      kb < 1 || kb > 65535 || nblk < 1 || nblk > INT32_MAX - kTileBlocks ||
      n_x < 1 || stage < 0 || stage > 2 ||
      smem_bytes(static_cast<int>(kb), static_cast<int>(stage)) > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  P.data = data;
  P.lanes = static_cast<const int32_t*>(lanes);
  P.bands = static_cast<const int32_t*>(bands);
  P.blocks = static_cast<const int32_t*>(blocks);
  P.band_lo = static_cast<const int32_t*>(band_lo);
  P.grp_ptr = static_cast<const int32_t*>(grp_ptr);
  P.grp_idx = static_cast<const int32_t*>(grp_idx);
  P.x = static_cast<const float*>(x);
  P.y = static_cast<float*>(y);
  P.n_x = n_x;
  P.gs = static_cast<int>(gs);
  P.kb = static_cast<int>(kb);
  P.nblk = static_cast<int>(nblk);
  P.halves = halves != 0;
  P.values_bf16 = values_bf16 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(nsteps);
  switch (stage) {
    case kStageBf16: return launch_scatter<kStageBf16>(P, n, scatter, s);
    case kStageF32: return launch_scatter<kStageF32>(P, n, scatter, s);
    default: return launch_scatter<kStageLoad>(P, n, scatter, s);
  }
}

}  // extern "C"
