// DIA sparse matrix-vector product y = A x, for NVIDIA Hopper (sm_90a).
//
//   y[i] = sum_k data[k, i] * x[i + offsets[k]],   k ascending,
//
// over the unpadded DIA container of pykrylov_tpu_torch.sparse.formats:
// data is (ndiag, m) row-major, offsets holds ndiag <= 4096 diagonal
// offsets in container order (unsorted or repeated offsets are summed in
// that order), x has n entries and y has m.  A term whose column
// i + offsets[k] falls outside [0, n) is skipped, never multiplied: a NaN
// or inf stored in such a slot does not reach y, and x is never read out
// of range.
//
// Replaces pykrylov_tpu/sparse/kernels.py::_dia_kernel_ring (and
// _dia_kernel, its one-block form), which computes the same product on a
// TPU over diagonals packed into (ndiag, m/128, 128) blocks, keeping each x
// block in a 4-slot VMEM ring so that x is read from HBM once.  Here the
// reuse of x comes from L1 and L2 (the +-n^2 rows of a Poisson stencil at
// n = 240 are 230 KB in f32), and there is no block or padding constraint
// on m or on the offsets.
//
// Bound: device-memory bytes.  A matvec moves (ndiag * s_d + 2 * s_x) * m
// bytes at best (s_d, s_x the storage sizes of data and x): for the 3-D
// Poisson matrix at n = 240 (m = 13.8M, 7 diagonals, f32) about 498 MB,
// 0.149 ms at the 3.35 TB/s an H100 SXM publishes, against 2 * 7 * m
// flops.  What held a one-thread-a-row loop well short of that (0.264 ms,
// 1.9 TB/s) was not the bytes but the loads in flight: 4-byte (bf16:
// 2-byte) loads, each behind a range branch and a serial sum.  The design,
// each step timed against the one before it by chip_dia_variants.py
// --spmv (PERF.md section 6):
//
// 1. Row groups.  One thread owns R consecutive rows, R = 16 bytes / s_d
//    (4 in f32, 8 in bf16, 2 in f64), loads each diagonal's R values as
//    one 16-byte vector and stores y as 16-byte vectors; neighbouring
//    threads own neighbouring groups, so a warp's loads are 512 contiguous
//    bytes a diagonal.  x[i + off .. i + off + R) has any alignment.  At
//    R = 2 and 4 it is read as R scalars, which mostly hit L1 (a warp's R
//    loads of one diagonal cover the same 128 R bytes); at R = 8 (bf16
//    storage) in the interior, as the two R-aligned vectors around it
//    combined in registers (kPairRows), which took 6% less time than the
//    scalars with an f32 x and 14% less with an f64 x, where at R = 2 and
//    4 it took up to 9% more.  R = 1 is the path for an m that R does not
//    divide (every container row after the first would start misaligned)
//    and for data, x or y that is not 16-byte aligned; the wrapper
//    (sparse/kernels.py::dia_mv_plan) chooses R.
// 2. Loads ahead of products.  A thread issues the data and x loads of a
//    chunk of diagonals before the chunk's first product, then adds the
//    products in ascending k; ndiag stays a runtime argument.  The chunk
//    holds kTerms = 8 terms: 8 / R diagonals (2 in f32, 1 in bf16, 4 in
//    f64, 8 on the scalar path).  Registers, not loads, set the depth:
//    32 terms (4 diagonals at R = 8) ran 1.4x slower in bf16 than one
//    diagonal at a time.
// 3. An unchecked interior.  A group whose every row has every term in
//    range, [lo, hi) = [max(0, -min off), min(m, n - max off)) from the
//    plan, runs without range checks; the groups at the two edges, a group
//    that straddles lo or hi, and every group when the interior is empty
//    keep the per-term check.  Index arithmetic is 32-bit within a tile
//    and 64-bit only for the tile's base (ndiag * m passes 2^31 at 64
//    diagonals of 34M rows).
//
// 4. Any number of diagonals up to dia_from_coo's 4096.  The offsets
//    travel by value in the kernel's parameters, where a warp reads them
//    through the constant cache with one address for all its threads.  Up
//    to 64 diagonals they go as int64 with a table of k * m beside them
//    (Offsets, 1 KB, the path timed above).  Past 64 they go as int32 and
//    k * m is worked out in the kernel (WideOffsets, 16 KB: CUDA 12.1+
//    takes up to 32,764 bytes of parameters); an offset outside (-m, n),
//    whose terms all lie outside the matrix, is clamped to -m or n, which
//    keeps it outside, so m and n must fit in 31 bits.  Both take the same
//    walk and the same sums.
//
// Measured slower and left out (chip_dia_variants.py keeps them as
// variants): persistent blocks walking the tiles in one wave (up to 13%
// slower than a block a tile on Poisson) and evict-first hints on the
// diagonals and y (within 0.8% on Poisson and with the f64 x of the
// convection-diffusion solves; 10% faster only with an f32 x there, whose
// 16.8 MB stay in L2 between the timed calls).  The grid is a block a
// tile.
//
// Products and sums are rounded one by one (__fmul_rn/__fadd_rn,
// __dmul_rn/__dadd_rn; no FMA contraction), in ascending k, from 0: what
// the plain torch version (kernels.dia_matvec_plain) computes, so the two
// agree bit for bit, as they do with the SpMM kernel (csrc/dia_spmm.cu)
// column by column.
//
// Types: f32 data with f32 x; bf16 data with f32 x (converted with
// __bfloat162float, f32 compute); f64 data with f64 x; f32 or bf16 data
// with f64 x (each stored value widened to double, which is exact, and f64
// compute: the plain version's .to(float64) promotion).  R follows the
// storage: an f64 y of an f32 group is two 16-byte stores.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns a CUDA error code as an int (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 64;       // diagonals of the Offsets path
constexpr int kWideDiags = 4096;    // diagonals of the WideOffsets path
constexpr int kThreads = 256;
constexpr int kTerms = 8;        // x loads a thread issues ahead of products
constexpr int kTileGroups = 1;   // row groups a thread takes in a tile
constexpr int kPairRows = 8;     // R from which x is two aligned vectors

struct Offsets {
  int ndiag;
  int64_t off[kMaxDiags];   // diagonal offsets, container order
  int64_t row[kMaxDiags];   // k * m: where diagonal k's values start

  __device__ __forceinline__ int64_t offset(int k) const { return off[k]; }
  __device__ __forceinline__ int64_t start(int k, int64_t) const {
    return row[k];
  }
};

struct WideOffsets {
  int ndiag;
  int32_t off[kWideDiags];  // diagonal offsets, container order, clamped

  __device__ __forceinline__ int64_t offset(int k) const { return off[k]; }
  __device__ __forceinline__ int64_t start(int k, int64_t m) const {
    return k * m;
  }
};

template <typename T, int R>
struct alignas(R * sizeof(T) >= 16 ? 16 : R * sizeof(T)) Pack {
  T v[R];
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

// The two streams read or written once: a group's values of one diagonal
// and its rows of y (chip_dia_variants.py times evict-first hints here).
template <typename P>
__device__ __forceinline__ P load_values(const P* p) {
  return *p;
}

template <typename P>
__device__ __forceinline__ void store_values(P* p, const P& v) {
  *p = v;
}

// x[j .. j + R) from the two R-aligned vectors around it, s = j mod R
// (the same for every group of a diagonal, so the switch does not
// diverge); the second vector is read only when s > 0, and lies inside x
// when R divides n and the group is interior.
template <int R, typename TC, int S = 0>
__device__ __forceinline__ void pick(int s, const Pack<TC, R>& a,
                                     const Pack<TC, R>* bp, TC (&out)[R]) {
  if constexpr (S < R) {
    if (s == S) {
      Pack<TC, R> b;
      if constexpr (S > 0) b = *bp;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (S == 0) {
          out[r] = a.v[r];
        } else {
          out[r] = r + S < R ? a.v[(r + S) % R] : b.v[(r + S) % R];
        }
      }
    } else {
      pick<R, TC, S + 1>(s, a, bp, out);
    }
  }
}

// Group [i, i + R): dr points at data[0, i], xr at x[i], yr at y[i]; m
// is the container's row count (its row stride).  CHECK tests each term's
// column against [0, n); an interior group skips the test.  PAIR reads x
// as two aligned vectors (R divides n).
template <bool CHECK, int R, typename TD, typename TC, typename O>
__device__ __forceinline__ void group_product(const O& o,
                                              const TD* __restrict__ dr,
                                              int64_t m,
                                              const TC* __restrict__ xr,
                                              int64_t i, int64_t n,
                                              TC* __restrict__ yr,
                                              bool pair) {
  // diagonals whose loads are issued before their products
  constexpr int kChunk = kTerms / R > 0 ? kTerms / R : 1;
  using DP = Pack<TD, R>;
  using YP = Pack<TC, R>;
  YP acc;
#pragma unroll
  for (int r = 0; r < R; ++r) acc.v[r] = TC(0);
  for (int k0 = 0; k0 < o.ndiag; k0 += kChunk) {
    DP dv[kChunk];
    TC xv[kChunk][R];
    bool live[kChunk][R];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = k0 + u;
      const bool on = k < o.ndiag;
#pragma unroll
      for (int r = 0; r < R; ++r) live[u][r] = on;
      if (on) {
        const int64_t off = o.offset(k);
        dv[u] = load_values(reinterpret_cast<const DP*>(dr + o.start(k, m)));
        if (CHECK) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int64_t j = i + r + off;
            live[u][r] = j >= 0 && j < n;
            if (live[u][r]) xv[u][r] = xr[off + r];
          }
        } else if (R >= kPairRows && pair) {
          const int s = static_cast<int>(((off % R) + R) % R);
          const Pack<TC, R>* ap =
              reinterpret_cast<const Pack<TC, R>*>(xr + off - s);
          const Pack<TC, R> a = *ap;
          pick<R, TC>(s, a, ap + 1, xv[u]);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) xv[u][r] = xr[off + r];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (live[u][r]) {
          acc.v[r] = add_rn(acc.v[r],
                            mul_rn(static_cast<TC>(to_compute(dv[u].v[r])),
                                   xv[u][r]));
        }
      }
    }
  }
  store_values(reinterpret_cast<YP*>(yr), acc);
}

template <typename TD, typename TC, int R, typename O>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const TD* __restrict__ data,
                    const __grid_constant__ O o,
                    const TC* __restrict__ x, TC* __restrict__ y, int64_t m,
                    int64_t n, int64_t lo, int64_t hi) {
  constexpr int kTileRows = kThreads * kTileGroups * R;
  const int64_t tiles = (m + kTileRows - 1) / kTileRows;
  const bool pair = R >= kPairRows && n % R == 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    // the tile's base in 64 bits; rows inside it in 32
    const int64_t i0 = t * kTileRows;
    const int rows =
        static_cast<int>(m - i0 < kTileRows ? m - i0 : kTileRows);
    const TD* db = data + i0;
    const TC* xb = x + i0;
    TC* yb = y + i0;
#pragma unroll
    for (int u = 0; u < kTileGroups; ++u) {
      // R divides m on the vector path, so every group is whole
      const int r0 = (u * kThreads + static_cast<int>(threadIdx.x)) * R;
      if (r0 < rows) {
        const int64_t i = i0 + r0;
        if (i >= lo && i + R <= hi) {
          group_product<false, R>(o, db + r0, m, xb + r0, i, n, yb + r0,
                                  pair);
        } else {
          group_product<true, R>(o, db + r0, m, xb + r0, i, n, yb + r0,
                                 pair);
        }
      }
    }
  }
}

template <typename TD, typename TC, int R, typename O>
int launch_kernel(const TD* data, const O& o, const TC* x, TC* y,
                  int64_t m, int64_t n, int64_t lo, int64_t hi,
                  cudaStream_t stream) {
  auto kernel = dia_spmv_kernel<TD, TC, R, O>;
  constexpr int64_t kTileRows = int64_t{kThreads} * kTileGroups * R;
  int64_t blocks = (m + kTileRows - 1) / kTileRows;  // a block a tile
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      data, o, x, y, m, n, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// An interior row i reads x[i + off] unchecked: [lo, hi) must keep every
// offset in range.
bool interior_ok(int64_t off, int64_t lo, int64_t hi, int64_t n) {
  return lo == hi || (lo + off >= 0 && hi + off <= n);
}

// An offset outside (-m, n) has no term inside the matrix; clamped to -m
// or n it still has none.
int64_t clamp_offset(int64_t off, int64_t m, int64_t n) {
  return off < -m ? -m : (off > n ? n : off);
}

template <typename TD, typename TC, int RW, typename O>
int launch_rows(const TD* d, const O& o, int64_t r, const TC* x, TC* y,
                int64_t m, int64_t n, int64_t lo, int64_t hi,
                cudaStream_t s) {
  if (r == 1) return launch_kernel<TD, TC, 1>(d, o, x, y, m, n, lo, hi, s);
  return launch_kernel<TD, TC, RW>(d, o, x, y, m, n, lo, hi, s);
}

// r rows a group (1, or RW = 16 bytes of storage when RW divides m and
// data, x and y are 16-byte aligned); [lo, hi) the interior the wrapper
// planned, which must lie inside the rows whose every term is in range.
template <typename TD, typename TC>
int launch(const void* data, const void* offsets, int64_t ndiag, int64_t r,
           int64_t lo, int64_t hi, const void* x, void* y, int64_t m,
           int64_t n, void* stream) {
  constexpr int RW = 16 / static_cast<int>(sizeof(TD));
  constexpr int64_t kMax32 = INT32_MAX;
  if (ndiag < 0 || ndiag > kWideDiags || m < 1 || n < 0 ||
      (ndiag > kMaxDiags && (m > kMax32 || n > kMax32)) ||
      (r != 1 && r != RW) ||
      (r == RW && (m % RW != 0 || !aligned16(data) || !aligned16(x) ||
                   !aligned16(y))) ||
      lo < 0 || lo > hi || hi > m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* src = static_cast<const int64_t*>(offsets);
  for (int64_t k = 0; k < ndiag; ++k) {
    if (!interior_ok(src[k], lo, hi, n)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const TD* d = static_cast<const TD*>(data);
  const TC* xs = static_cast<const TC*>(x);
  TC* ys = static_cast<TC*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndiag <= kMaxDiags) {
    Offsets o = {};
    o.ndiag = static_cast<int>(ndiag);
    for (int k = 0; k < o.ndiag; ++k) {
      o.off[k] = src[k];
      o.row[k] = k * m;
    }
    return launch_rows<TD, TC, RW>(d, o, r, xs, ys, m, n, lo, hi, s);
  }
  // the slots past ndiag are never read
  WideOffsets o;
  o.ndiag = static_cast<int>(ndiag);
  for (int k = 0; k < o.ndiag; ++k) {
    o.off[k] = static_cast<int32_t>(clamp_offset(src[k], m, n));
  }
  return launch_rows<TD, TC, RW>(d, o, r, xs, ys, m, n, lo, hi, s);
}

}  // namespace

#define DIA_SPMV_ENTRY(NAME, TD, TC)                                        \
  int NAME(const void* data, const void* offsets, int64_t ndiag, int64_t r, \
           int64_t lo, int64_t hi, const void* x, void* y, int64_t m,       \
           int64_t n, void* stream) {                                       \
    return launch<TD, TC>(data, offsets, ndiag, r, lo, hi, x, y, m, n,      \
                          stream);                                          \
  }

extern "C" {

DIA_SPMV_ENTRY(dia_spmv_f32, float, float)
DIA_SPMV_ENTRY(dia_spmv_bf16, __nv_bfloat16, float)
DIA_SPMV_ENTRY(dia_spmv_f64, double, double)
DIA_SPMV_ENTRY(dia_spmv_f32f64, float, double)
DIA_SPMV_ENTRY(dia_spmv_bf16f64, __nv_bfloat16, double)

}  // extern "C"
