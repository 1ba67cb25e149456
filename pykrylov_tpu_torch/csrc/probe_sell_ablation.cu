// The SELL-C-sigma SpMV, whole and with one part removed at a time, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probes that take the BELL kernel apart:
// tools/probes/probe_bell_ablation.py::make_kernel (the pallas_call at
// :111; DMA, staging or scatter removed), probe_bell_ablation_w1.py (:129;
// unpack, gather, multiply, group sum or staging removed),
// probe_ablate_r3.py (:149; one op a variant replaced by a stand-in) and
// probe_skew.py (:169; step s + 1 staged while step s is consumed).  On
// the card the same product is the SELL SpMV over the card form
// (csrc/sell_spmv.cu, whose walk this source keeps: one warp a slice of 32
// slot rows, a thread a slot row, the value and column streams read
// coalesced through ld.global.nc.L1::no_allocate, rows walked in chunks of
// eight entries whose loads are issued before their products, x gathered
// through the read-only path, y[row_idx[t]] written once).
//
// The TPU probes' ablated variants returned wrong values by design.  Here
// every variant is a defined function, with a plain torch version in
// probes/sell_ablation.py that the kernel equals bit for bit, so the
// compiler cannot drop the work a variant keeps.  A variant that removes a
// stream keeps reading every other stream and folds it into the result.
// For slot row t < rows of length L_t, entries p_j (j < L_t) with value
// v_j and column c_j, output row r_t = row_idx[t], and x of n_x > 0
// entries ([.]: the term is added only if 0 <= c_j < n_x; f(c) is the
// column converted to float, rounded to nearest):
//
//   full          y[r_t] = sum_j [v_j * x[c_j]]           (sell_matvec)
//   skew          the same, with chunk j + 1's x gathers and chunk j + 2's
//                 value and column loads issued before chunk j's products
//   no-gather     y[r_t] = sum_j (v_j * x[t mod n_x] + f(c_j >> 30))
//                 (x at the slot row's own index; c >> 30 is 0 for every
//                 column below 2^30, so the column loads stay)
//   no-columns    y[r_t] = sum_j v_j * x[t mod n_x]       (no column stream)
//   no-values     y[r_t] = sum_j [x[c_j]]                 (no value stream)
//   streams-only  y[r_t] = sum_j (v_j + f(c_j))           (no x at all)
//   no-scatter    y[t]   = sum_j [v_j * x[c_j]]           (row_idx unread)
//
// Each sum runs in ascending j from 0, every product and sum rounded on
// its own (__fmul_rn, __fadd_rn, __int2float_rn).  f32 values, f32 x.
//
// Bound: device-memory bytes, each variant the bytes it still moves: the
// streams it reads (4-byte values and columns of every entry), the row
// lengths, output rows (unless no-scatter) and slice pointers, x once
// (what the rows gather, or the own-index reads) and y once.
//
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 32;     // slot rows per slice: one warp
constexpr int kThreads = 256;  // 8 slices per block
constexpr int kUnroll = 8;     // entries loaded ahead of their products

enum Variant {
  kFull = 0,
  kSkew = 1,
  kNoGather = 2,
  kNoColumns = 3,
  kNoValues = 4,
  kStreamsOnly = 5,
  kNoScatter = 6,
};

__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int32_t ld_stream(const int32_t* p) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

struct Chunk {
  int32_t c[kUnroll];
  float v[kUnroll];
  float x[kUnroll];
};

// The value and column loads of entries j .. j + 8 (masked past len:
// column -1, skipped; value 0).
template <int V>
__device__ __forceinline__ void load_streams(Chunk& ch, const float* v,
                                             const int32_t* c, int j,
                                             int len) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool live = j + u < len;
    if constexpr (V != kNoColumns) {
      ch.c[u] = live ? ld_stream(c + (j + u) * kSlice) : -1;
    } else {
      ch.c[u] = live ? 0 : -1;
    }
    if constexpr (V != kNoValues) {
      ch.v[u] = live ? ld_stream(v + (j + u) * kSlice) : 0.f;
    }
  }
}

__device__ __forceinline__ void gather(Chunk& ch, const float* x,
                                       int64_t n_x) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    ch.x[u] = ch.c[u] >= 0 && ch.c[u] < n_x ? __ldg(x + ch.c[u]) : 0.f;
  }
}

// Chunk j's terms added into acc in ascending order.
template <int V>
__device__ __forceinline__ float add_terms(float acc, const Chunk& ch,
                                           int j, int len, int64_t n_x,
                                           float xs) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool live = j + u < len;
    const bool valid = ch.c[u] >= 0 && ch.c[u] < n_x;
    if constexpr (V == kNoGather) {
      if (live) {
        acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(ch.v[u], xs),
                                       __int2float_rn(ch.c[u] >> 30)));
      }
    } else if constexpr (V == kNoColumns) {
      if (live) acc = __fadd_rn(acc, __fmul_rn(ch.v[u], xs));
    } else if constexpr (V == kNoValues) {
      if (valid) acc = __fadd_rn(acc, ch.x[u]);
    } else if constexpr (V == kStreamsOnly) {
      if (live) {
        acc = __fadd_rn(acc, __fadd_rn(ch.v[u], __int2float_rn(ch.c[u])));
      }
    } else {   // full, skew, no-scatter
      if (valid) acc = __fadd_rn(acc, __fmul_rn(ch.v[u], ch.x[u]));
    }
  }
  return acc;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    sell_ablation_kernel(const float* __restrict__ vals,
                         const int32_t* __restrict__ cols,
                         const int64_t* __restrict__ slice_ptr,
                         const int32_t* __restrict__ row_len,
                         const int32_t* __restrict__ row_idx,
                         const float* __restrict__ x, int64_t n_x,
                         float* __restrict__ y, int64_t rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows) return;
  const int len = row_len[t];
  const int64_t p0 = slice_ptr[t / kSlice] + t % kSlice;
  const float* v = vals + p0;
  const int32_t* c = cols + p0;
  constexpr bool kGathers = V == kFull || V == kSkew || V == kNoValues ||
                            V == kNoScatter;
  float xs = 0.f;
  if constexpr (V == kNoGather || V == kNoColumns) xs = __ldg(x + t % n_x);
  float acc = 0.f;
  if constexpr (V == kSkew) {
    // chunk j + 1's x gathers and chunk j + 2's value and column loads
    // are issued before chunk j's products
    Chunk cur, nxt;
    if (len > 0) {
      load_streams<V>(cur, v, c, 0, len);
      load_streams<V>(nxt, v, c, kUnroll, len);
      gather(cur, x, n_x);
    }
    for (int j = 0; j < len; j += kUnroll) {
      if (j + kUnroll < len) gather(nxt, x, n_x);
      Chunk after;   // masked past len: no load
      load_streams<V>(after, v, c, j + 2 * kUnroll, len);
      acc = add_terms<V>(acc, cur, j, len, n_x, xs);
      cur = nxt;
      nxt = after;
    }
  } else {
    for (int j = 0; j < len; j += kUnroll) {
      Chunk ch;
      load_streams<V>(ch, v, c, j, len);
      if constexpr (kGathers) gather(ch, x, n_x);
      acc = add_terms<V>(acc, ch, j, len, n_x, xs);
    }
  }
  if constexpr (V == kNoScatter) {
    y[t] = acc;
  } else {
    y[row_idx[t]] = acc;
  }
}

template <int V>
int launch(const float* vals, const int32_t* cols, const int64_t* slice_ptr,
           const int32_t* row_len, const int32_t* row_idx, const float* x,
           int64_t n_x, float* y, int64_t rows, cudaStream_t stream) {
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  sell_ablation_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            stream>>>(vals, cols, slice_ptr, row_len,
                                      row_idx, x, n_x, y, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant: 0 full, 1 skew, 2 no-gather, 3 no-columns, 4 no-values,
// 5 streams-only, 6 no-scatter
int probe_sell_ablation_f32(const void* vals, const void* cols,
                            const void* slice_ptr, const void* row_len,
                            const void* row_idx, const void* x, int64_t n_x,
                            void* y, int64_t rows, int64_t variant,
                            void* stream) {
  if (rows < 1 || n_x < 1 || (rows + kThreads - 1) / kThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* v = static_cast<const float*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const int64_t* sp = static_cast<const int64_t*>(slice_ptr);
  const int32_t* rl = static_cast<const int32_t*>(row_len);
  const int32_t* ri = static_cast<const int32_t*>(row_idx);
  const float* xs = static_cast<const float*>(x);
  float* ys = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return launch<kFull>(v, c, sp, rl, ri, xs, n_x, ys, rows, s);
    case kSkew: return launch<kSkew>(v, c, sp, rl, ri, xs, n_x, ys, rows, s);
    case kNoGather:
      return launch<kNoGather>(v, c, sp, rl, ri, xs, n_x, ys, rows, s);
    case kNoColumns:
      return launch<kNoColumns>(v, c, sp, rl, ri, xs, n_x, ys, rows, s);
    case kNoValues:
      return launch<kNoValues>(v, c, sp, rl, ri, xs, n_x, ys, rows, s);
    case kStreamsOnly:
      return launch<kStreamsOnly>(v, c, sp, rl, ri, xs, n_x, ys, rows, s);
    case kNoScatter:
      return launch<kNoScatter>(v, c, sp, rl, ri, xs, n_x, ys, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
