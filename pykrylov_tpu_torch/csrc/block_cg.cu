// Block CG's vector work (solvers/batched.py, cg_batched) in three passes
// over the solve's (n, K) row-major blocks, for NVIDIA Hopper (sm_90a):
//
//   coldot     s_k = a_k' b_k for each column k: pAp = P'AP, and R'Y when a
//              preconditioner M is given;
//   update_r   R <- R - alpha o AP in place, with s_k = R'R of the new R
//              summed in the same pass when there is no M;
//   update_xp  X <- X + alpha o P and P <- Y + beta o P in place, in one
//              pass (Y is R when there is no M): a thread reads the old P
//              once and writes both results.
//
// Every write is under the iteration's mask: a column whose act flag is
// false gets its old values written back, bit for bit (not x + 0 * p, which
// a non-finite p would spoil), as the torch path's torch.where selects.
//
// Replaces no TPU kernel: the JAX package's while_loop body leaves these
// passes to XLA's fusion.  The port's torch path makes 17 block passes an
// iteration where the arithmetic needs 10: two torch.linalg.vecdot column
// dots of 4 passes each (read two blocks, write their product, read it back
// to sum), three addcmul of 3 passes, and once any column has stopped three
// block-wide torch.where of 3 more; and about 38 small operators on the (K,)
// scalars, which pace the loop on small systems.
//
// Bound: device-memory bytes.  With s the element size, an iteration moves
//   coldot 2, update_r 3, update_xp 5 passes of n * K * s bytes,
// plus 2 for M's coldot(R, Y): at n = 13,824,000 and K = 8 in float32 a pass
// is 442.4 MB, 10 passes 1.32 ms at the 3.35 TB/s an H100 SXM publishes
// (NVIDIA H100 80GB HBM3, 700 W).  The arithmetic is 2-3 flops an element.
// Measured there: coldot 0.297-0.302 ms, update_r 0.475-0.476 ms, update_xp
// 0.777-0.780 ms, 1.55 ms an iteration, 85% of that bound (in float64 86%),
// against 2.66-2.75 ms for the torch path's vector work.
//
// Design:
//
// 1. Loads and stores of 16 bytes (V = 4 in float32, 2 in float64), with
//    neighbouring threads on neighbouring addresses, when V divides K and
//    every block is 16-byte aligned; else V = 1 (K = 3 in float32, a row of
//    12 bytes), still coalesced.  The wrapper (solvers/block_cg.py,
//    block_cg_plan) chooses V and the grid.
// 2. A grid-stride loop over vectors whose stride, blocks * kThreads * V
//    elements, is a multiple of K: a thread always meets the same V
//    columns, so it reads their scalars once and keeps their partial sums
//    in registers.  kMinBlocks blocks of kThreads an SM and kUnroll vectors
//    of each block read in flight a thread keep 32 KB of each read in
//    flight an SM, above what 3.35 TB/s over ~700 ns of latency asks of
//    each of the 132 SMs (~18 KB).  Measured at n = 13.8M, K = 8: unroll 1,
//    2 or 4 with 2 or 4 blocks an SM all within 4% of each other; 8 blocks
//    an SM (32 registers, spills) run 1.2-1.5x slower.
// 3. The column sums go across blocks in two stages, in a fixed order and
//    in float64: a block folds its threads' partials in shared memory at
//    strides that are multiples of K (each column's terms stay in one
//    residue class) and writes one partial a column; the last block to
//    finish (a ticket taken after __threadfence) sums the blocks' partials
//    in a fixed order.  No float atomics, so a solve repeats its iteration
//    counts from run to run.
// 4. The last block also runs the iteration's per-column scalar step on the
//    K sums, rounded to the block's type, with the torch path's rules:
//    after P'AP the curvature test and alpha (alpha_step), after R'R or R'Y
//    the residual, the stop tests, beta, the history row, the counts and the
//    mask, and the poll's two flags, any and all columns active (beta_step).
//    The host reads those two flags once an iteration.
//
// Types: float32 and float64 blocks, the per-column scalars in the same
// type.  Each entry point launches on the given stream, does not
// synchronise, and returns a CUDA error code as an int (0 on success).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;   // blocks an SM (solvers/block_cg.py)
constexpr int kUnroll = 2;      // vectors in flight a thread
constexpr int kAlpha = 0;       // the scalar step after P'AP
constexpr int kBeta = 1;        // the scalar step after R'R or R'Y

// The solve's per-column state (K entries each), in the order of the
// wrapper's pointer table, and the history row of this iteration (or null).
template <typename T>
struct Cols {
  T* ry;
  T* resid;
  const T* thresh;
  T* alpha;
  T* beta;
  bool* act;
  bool* active;
  bool* definite;
  int32_t* iters;
  bool* flags;
  T* hist;
  int check;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Fold s[0, len) at strides that are multiples of unit, so that s[i] for
// i < min(unit, len) ends up holding the sum of every s[j] with j = i
// (mod unit), in a fixed order.  The whole block calls it.
__device__ void fold(double* s, int len, int unit) {
  if (unit >= len) return;
  int h = unit;
  while (2 * h < len) h *= 2;
  for (; h >= unit; h /= 2) {
    for (int i = threadIdx.x; i < h; i += kThreads) {
      if (i + h < len) s[i] += s[i + h];
    }
    __syncthreads();
    len = h;
  }
}

template <typename T>
__device__ void alpha_step(const Cols<T>& st, int c, double sum) {
  const T pap = static_cast<T>(sum);
  const bool on = st.active[c];
  const bool bad = st.check && on && pap <= T(0);
  const bool act = on && !bad;
  st.act[c] = act;
  st.alpha[c] = act ? st.ry[c] / (pap == T(0) ? T(1) : pap) : T(0);
  if (bad) st.definite[c] = false;
}

template <typename T>
__device__ void beta_step(const Cols<T>& st, int c, double sum) {
  const T ry2 = static_cast<T>(sum);
  const bool act = st.act[c];
  const bool on = st.active[c];
  const T ry = st.ry[c];
  // clamp below at 0 keeping a NaN, as torch.clamp does
  const T resid = act ? sqrt(ry2 < T(0) ? T(0) : ry2) : st.resid[c];
  const bool done = act && (resid <= st.thresh[c] || !isfinite(resid));
  st.beta[c] = act ? ry2 / (ry == T(0) ? T(1) : ry) : T(0);
  if (st.hist != nullptr) st.hist[c] = on ? resid : T(NAN);
  if (act) st.ry[c] = ry2;
  st.resid[c] = resid;
  st.iters[c] += on ? 1 : 0;
  st.active[c] = act && !done;
}

// The end of a summing pass: the block's partials, the ticket, and in the
// last block the column sums and the scalar step.
template <typename T, int V, int Step>
__device__ void finish(const double (&acc)[V], int K, double* partial,
                       unsigned* ticket, const Cols<T>& st) {
  constexpr int L = kThreads * V;
  __shared__ double s[L];
  __shared__ bool last;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) s[tid * V + j] = acc[j];
  __syncthreads();
  fold(s, L, K);
  // s[f], f < min(K, L), holds the block's sum of column (base + f) mod K
  const int base = static_cast<int>((static_cast<int64_t>(blockIdx.x) * L) % K);
  const int held = K < L ? K : L;
  for (int c = tid; c < K; c += kThreads) {
    const int f = (c - base + K) % K;
    partial[static_cast<int64_t>(blockIdx.x) * K + c] = f < held ? s[f] : 0.0;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int nb = gridDim.x;
  if (K <= kThreads) {
    // groups of K threads each sum every groups-th block, then fold
    const int groups = kThreads / K;
    if (tid < groups * K) {
      const int c = tid % K;
      double v = 0.0;
      for (int b = tid / K; b < nb; b += groups) {
        v += __ldcg(partial + static_cast<int64_t>(b) * K + c);
      }
      s[tid] = v;
    }
    __syncthreads();
    fold(s, groups * K, K);
    if (tid < K) {
      if (Step == kAlpha) alpha_step(st, tid, s[tid]);
      else beta_step(st, tid, s[tid]);
    }
  } else {
    for (int c = tid; c < K; c += kThreads) {
      double v = 0.0;
      for (int b = 0; b < nb; ++b) {
        v += __ldcg(partial + static_cast<int64_t>(b) * K + c);
      }
      if (Step == kAlpha) alpha_step(st, c, v);
      else beta_step(st, c, v);
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (Step == kBeta) {
      bool any = false, all = true;
      for (int c = 0; c < K; ++c) {
        any = any || st.active[c];
        all = all && st.active[c];
      }
      st.flags[0] = any;
      st.flags[1] = all;
    }
    *ticket = 0u;   // ready for the next pass
  }
}

// This thread's first element's column: the stride keeps it.
template <int V>
__device__ int first_col(int K) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  return static_cast<int>((g * V) % K);
}

template <typename T, int V>
__device__ __forceinline__ void dot(const Pack<T, V>& a, const Pack<T, V>& b,
                                    double (&acc)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc[j] += static_cast<double>(a.v[j]) * static_cast<double>(b.v[j]);
  }
}

template <typename T, int V, int Step>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_cg_coldot(const T* __restrict__ a, const T* __restrict__ b,
                int64_t nvec, int K, Cols<T> st, double* partial,
                unsigned* ticket) {
  using P = Pack<T, V>;
  const P* pa = reinterpret_cast<const P*>(a);
  const P* pb = reinterpret_cast<const P*>(b);
  const int64_t G = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  double acc[V] = {};
  for (; i + (kUnroll - 1) * G < nvec; i += kUnroll * G) {
    P av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = pa[i + u * G];
      bv[u] = pb[i + u * G];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dot(av[u], bv[u], acc);
  }
  for (; i < nvec; i += G) dot(pa[i], pb[i], acc);
  finish<T, V, Step>(acc, K, partial, ticket, st);
}

template <typename T, int V>
__device__ __forceinline__ void step_r(Pack<T, V>& r, const Pack<T, V>& ap,
                                       const bool (&on)[V],
                                       const T (&alpha)[V], double (&acc)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (on[j]) r.v[j] = r.v[j] - alpha[j] * ap.v[j];
    acc[j] += static_cast<double>(r.v[j]) * static_cast<double>(r.v[j]);
  }
}

template <typename T, int V, bool Sum>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_cg_update_r(T* __restrict__ r, const T* __restrict__ ap, int64_t nvec,
                  int K, Cols<T> st, double* partial, unsigned* ticket) {
  using P = Pack<T, V>;
  P* pr = reinterpret_cast<P*>(r);
  const P* pap = reinterpret_cast<const P*>(ap);
  const int c0 = first_col<V>(K);
  bool on[V];
  T alpha[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    on[j] = st.act[c0 + j];
    alpha[j] = st.alpha[c0 + j];
  }
  const int64_t G = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  double acc[V] = {};
  for (; i + (kUnroll - 1) * G < nvec; i += kUnroll * G) {
    P rv[kUnroll], av[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rv[u] = pr[i + u * G];
      av[u] = pap[i + u * G];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      step_r(rv[u], av[u], on, alpha, acc);
      pr[i + u * G] = rv[u];
    }
  }
  for (; i < nvec; i += G) {
    P rv = pr[i];
    step_r(rv, pap[i], on, alpha, acc);
    pr[i] = rv;
  }
  if constexpr (Sum) finish<T, V, kBeta>(acc, K, partial, ticket, st);
}

template <typename T, int V>
__device__ __forceinline__ void step_xp(Pack<T, V>& x, Pack<T, V>& p,
                                        const Pack<T, V>& y,
                                        const bool (&on)[V],
                                        const T (&alpha)[V],
                                        const T (&beta)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (on[j]) {
      x.v[j] = x.v[j] + alpha[j] * p.v[j];
      p.v[j] = y.v[j] + beta[j] * p.v[j];
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_cg_update_xp(T* __restrict__ x, T* __restrict__ p,
                   const T* __restrict__ y, int64_t nvec, int K, Cols<T> st) {
  using P = Pack<T, V>;
  P* px = reinterpret_cast<P*>(x);
  P* pp = reinterpret_cast<P*>(p);
  const P* py = reinterpret_cast<const P*>(y);
  const int c0 = first_col<V>(K);
  bool on[V];
  T alpha[V], beta[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    on[j] = st.act[c0 + j];
    alpha[j] = st.alpha[c0 + j];
    beta[j] = st.beta[c0 + j];
  }
  const int64_t G = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * G < nvec; i += kUnroll * G) {
    P xv[kUnroll], pv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = px[i + u * G];
      pv[u] = pp[i + u * G];
      yv[u] = py[i + u * G];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      step_xp(xv[u], pv[u], yv[u], on, alpha, beta);
      px[i + u * G] = xv[u];
      pp[i + u * G] = pv[u];
    }
  }
  for (; i < nvec; i += G) {
    P xv = px[i], pv = pp[i];
    step_xp(xv, pv, py[i], on, alpha, beta);
    px[i] = xv;
    pp[i] = pv;
  }
}

// The wrapper's table of state pointers, in Cols' order.
template <typename T>
Cols<T> cols_of(void* const* state, int check, void* hist) {
  Cols<T> st;
  st.ry = static_cast<T*>(state[0]);
  st.resid = static_cast<T*>(state[1]);
  st.thresh = static_cast<const T*>(state[2]);
  st.alpha = static_cast<T*>(state[3]);
  st.beta = static_cast<T*>(state[4]);
  st.act = static_cast<bool*>(state[5]);
  st.active = static_cast<bool*>(state[6]);
  st.definite = static_cast<bool*>(state[7]);
  st.iters = static_cast<int32_t*>(state[8]);
  st.flags = static_cast<bool*>(state[9]);
  st.hist = static_cast<T*>(hist);
  st.check = check;
  return st;
}

// The plan's rules: V is 1 or 16 bytes of T and divides K, the elements
// are whole vectors, and the grid's stride is a multiple of K.
template <typename T>
bool valid(int64_t n, int64_t k, int v, int blocks) {
  constexpr int vw = 16 / sizeof(T);
  return k >= 1 && k <= (int64_t(1) << 30) && n >= 0 && blocks >= 1
         && (v == 1 || (v == vw && k % vw == 0)) && n % k == 0
         && (static_cast<int64_t>(blocks) * kThreads * v) % k == 0;
}

template <typename T>
int coldot(const void* a, const void* b, int64_t n, int64_t k, int v,
           int blocks, int step, void* const* state, int check, void* hist,
           void* partial, void* ticket, void* stream) {
  if (!valid<T>(n, k, v, blocks) || (step != kAlpha && step != kBeta)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const Cols<T> st = cols_of<T>(state, check, hist);
  double* part = static_cast<double*>(partial);
  unsigned* tk = static_cast<unsigned*>(ticket);
  const int K = static_cast<int>(k);
  constexpr int vw = 16 / sizeof(T);
#define COLDOT(VV, STEP)                                                   \
  block_cg_coldot<T, VV, STEP><<<blocks, kThreads, 0, s>>>(                \
      pa, pb, n / VV, K, st, part, tk)
  if (v == 1) {
    if (step == kAlpha) COLDOT(1, kAlpha); else COLDOT(1, kBeta);
  } else {
    if (step == kAlpha) COLDOT(vw, kAlpha); else COLDOT(vw, kBeta);
  }
#undef COLDOT
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_r(void* r, const void* ap, int64_t n, int64_t k, int v,
             int blocks, int sum, void* const* state, void* hist,
             void* partial, void* ticket, void* stream) {
  if (!valid<T>(n, k, v, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* pr = static_cast<T*>(r);
  const T* pap = static_cast<const T*>(ap);
  const Cols<T> st = cols_of<T>(state, 0, hist);
  double* part = static_cast<double*>(partial);
  unsigned* tk = static_cast<unsigned*>(ticket);
  const int K = static_cast<int>(k);
  constexpr int vw = 16 / sizeof(T);
#define UPDATE_R(VV, SUM)                                                  \
  block_cg_update_r<T, VV, SUM><<<blocks, kThreads, 0, s>>>(               \
      pr, pap, n / VV, K, st, part, tk)
  if (v == 1) {
    if (sum) UPDATE_R(1, true); else UPDATE_R(1, false);
  } else {
    if (sum) UPDATE_R(vw, true); else UPDATE_R(vw, false);
  }
#undef UPDATE_R
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_xp(void* x, void* p, const void* y, int64_t n, int64_t k, int v,
              int blocks, void* const* state, void* stream) {
  if (!valid<T>(n, k, v, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* px = static_cast<T*>(x);
  T* pp = static_cast<T*>(p);
  const T* py = static_cast<const T*>(y);
  const Cols<T> st = cols_of<T>(state, 0, nullptr);
  const int K = static_cast<int>(k);
  if (v == 1) {
    block_cg_update_xp<T, 1><<<blocks, kThreads, 0, s>>>(px, pp, py, n, K,
                                                         st);
  } else {
    constexpr int vw = 16 / sizeof(T);
    block_cg_update_xp<T, vw><<<blocks, kThreads, 0, s>>>(px, pp, py,
                                                          n / vw, K, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BLOCK_CG_ENTRIES(SUFFIX, T)                                         \
  int block_cg_coldot_##SUFFIX(const void* a, const void* b, int64_t n,     \
                               int64_t k, int v, int blocks, int step,      \
                               void* const* state, int check, void* hist,   \
                               void* partial, void* ticket, void* stream) { \
    return coldot<T>(a, b, n, k, v, blocks, step, state, check, hist,       \
                     partial, ticket, stream);                              \
  }                                                                         \
  int block_cg_update_r_##SUFFIX(void* r, const void* ap, int64_t n,        \
                                 int64_t k, int v, int blocks, int sum,     \
                                 void* const* state, void* hist,            \
                                 void* partial, void* ticket,               \
                                 void* stream) {                            \
    return update_r<T>(r, ap, n, k, v, blocks, sum, state, hist, partial,   \
                       ticket, stream);                                     \
  }                                                                         \
  int block_cg_update_xp_##SUFFIX(void* x, void* p, const void* y,          \
                                  int64_t n, int64_t k, int v, int blocks,  \
                                  void* const* state, void* stream) {       \
    return update_xp<T>(x, p, y, n, k, v, blocks, state, stream);           \
  }

extern "C" {

BLOCK_CG_ENTRIES(f32, float)
BLOCK_CG_ENTRIES(f64, double)

}  // extern "C"

#undef BLOCK_CG_ENTRIES
