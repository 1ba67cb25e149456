// One-hot products on the tensor cores of NVIDIA Hopper (sm_90a), through
// mma.sync: the pieces of the probes that ask whether the matrix unit can
// do a gather's or a scatter's work (csrc/probe_onehot_mma.cu,
// csrc/probe_bell_mma.cu).
//
// A one-hot operand is never read from memory.  Its A fragment is built in
// registers from an index, as the TPU kernels built `iota == base`:
//
//   rows form     A[r][k] = (idx[r] == k)   a gather: row r of the product
//                                           is row idx[r] of B
//   columns form  A[r][k] = (idx[k] == r)   a scatter: row r of the product
//                                           sums the rows k of B whose
//                                           index is r
//
// An f32 B travels in pieces that each fit the operand type exactly, one
// product a piece, each summed in f32:
//
//   bf16 x 3   p1 = bf16(v), p2 = bf16(v - p1), p3 = bf16(v - p1 - p2)
//              (round to nearest even), on m16n8k16.bf16
//   tf32 x 3   the same with cvt.rna.tf32.f32 (nearest, ties away from
//              zero), on m16n8k8.tf32: each piece has its low 13 bits 0,
//              so the bits the tensor core drops lose nothing
//   u8 x 4     the four bytes of v's bits, on m16n8k32.u8 with s32 sums:
//              a one-hot row sums one byte, exactly
//
// Three bf16 or tf32 pieces hold every finite f32 outside the subnormal
// range exactly, and (p1 + p2) + p3 gives it back, so a one-hot gather of
// finite values is exact in every transport.  A non-finite value is not:
// 0 * inf and 0 * NaN are NaN, so it turns its whole column of the
// product into NaN (and -0 comes back as +0, since the +0 of the other
// rows is added to it).  The byte planes carry every bit pattern.
//
// Fragment layouts (PTX ISA, mma.sync; g = lane / 4, t = lane % 4; the
// lower column or row of a packed pair in the lower bits):
//
//   m16n8k16 bf16  A: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..)
//                  B: b0 (2t..2t+1, g)  b1 (2t+8..2t+9, g)
//   m16n8k8 tf32   A: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                  B: b0 (t, g)  b1 (t+4, g)
//   m16n8k32 u8    A: a0 (g, 4t..4t+3)  a1 (g+8, 4t..)  a2 (g, 4t+16..)
//                     a3 (g+8, 4t+16..)
//                  B: b0 (4t..4t+3, g)  b1 (4t+16..4t+19, g)
//   C and D        c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace onehot_mma {

constexpr uint32_t kOneBf16 = 0x3F80u;       // 1.0 in bf16
constexpr uint32_t kOneTf32 = 0x3F800000u;   // 1.0 in tf32 (f32 bits)

// Fragment depths (k) of the three shapes.
constexpr int kKBf16 = 16;
constexpr int kKTf32 = 8;
constexpr int kKU8 = 32;

__device__ __forceinline__ int frag_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int frag_t() { return threadIdx.x & 3; }

// ---------------------------------------------------------------- A, rows
// `lo` and `hi`: the indices of rows g and g + 8; k0: the first column of
// this k-chunk.  An index outside the chunk gives a zero row.

// The pair (d == 0, d == 1) as packed bf16 ones.
__device__ __forceinline__ uint32_t bf16_pair(int d) {
  return d == 0 ? kOneBf16 : (d == 1 ? kOneBf16 << 16 : 0u);
}

__device__ __forceinline__ void a_rows_bf16(uint32_t a[4], int lo, int hi,
                                            int k0) {
  const int c = k0 + 2 * frag_t();
  a[0] = bf16_pair(lo - c);
  a[1] = bf16_pair(hi - c);
  a[2] = bf16_pair(lo - c - 8);
  a[3] = bf16_pair(hi - c - 8);
}

__device__ __forceinline__ void a_rows_tf32(uint32_t a[4], int lo, int hi,
                                            int k0) {
  const int c = k0 + frag_t();
  a[0] = lo == c ? kOneTf32 : 0u;
  a[1] = hi == c ? kOneTf32 : 0u;
  a[2] = lo == c + 4 ? kOneTf32 : 0u;
  a[3] = hi == c + 4 ? kOneTf32 : 0u;
}

// Byte d of a word set to 1, for d in [0, 4); else 0.
__device__ __forceinline__ uint32_t u8_quad(int d) {
  return static_cast<unsigned>(d) < 4u ? 1u << (8 * d) : 0u;
}

__device__ __forceinline__ void a_rows_u8(uint32_t a[4], int lo, int hi,
                                          int k0) {
  const int c = k0 + 4 * frag_t();
  a[0] = u8_quad(lo - c);
  a[1] = u8_quad(hi - c);
  a[2] = u8_quad(lo - c - 16);
  a[3] = u8_quad(hi - c - 16);
}

// ------------------------------------------------------------- A, columns
// `cidx`: the indices of this k-chunk's columns (kKBf16 or kKTf32 of
// them), counted from the tile's row 0.

__device__ __forceinline__ void a_cols_bf16(uint32_t a[4], const int* cidx) {
  const int g = frag_g(), t2 = 2 * frag_t();
  const auto pair = [&](int c, int r) {
    return (cidx[c] == r ? kOneBf16 : 0u) |
           (cidx[c + 1] == r ? kOneBf16 << 16 : 0u);
  };
  a[0] = pair(t2, g);
  a[1] = pair(t2, g + 8);
  a[2] = pair(t2 + 8, g);
  a[3] = pair(t2 + 8, g + 8);
}

__device__ __forceinline__ void a_cols_tf32(uint32_t a[4], const int* cidx) {
  const int g = frag_g(), t = frag_t();
  a[0] = cidx[t] == g ? kOneTf32 : 0u;
  a[1] = cidx[t] == g + 8 ? kOneTf32 : 0u;
  a[2] = cidx[t + 4] == g ? kOneTf32 : 0u;
  a[3] = cidx[t + 4] == g + 8 ? kOneTf32 : 0u;
}

// ------------------------------------------------------------------ pieces

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 h) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(h));
}

// The three bf16 pieces of v, as bits.
__device__ __forceinline__ void split_bf16(float v, uint32_t p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    p[i] = bf16_bits(h);
    v = __fsub_rn(v, __bfloat162float(h));
  }
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// The three tf32 pieces of v, as f32 bits with the low 13 bits 0.
__device__ __forceinline__ void split_tf32(float v, uint32_t p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = to_tf32(v);
    v = __fsub_rn(v, __uint_as_float(p[i]));
  }
}

// ------------------------------------------------------------ ldmatrix

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices, transposed: lanes 8m .. 8m + 7 give the row
// addresses (16 bytes each) of matrix m, and r[m] holds rows 2t, 2t + 1 of
// column g of it.  From a [k][n] bf16 layout, matrices (k0, n0), (k0 + 8,
// n0), (k0, n0 + 8), (k0 + 8, n0 + 8) give the B fragments (b0, b1) of the
// n-tiles at n0 and n0 + 8 of m16n8k16.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ------------------------------------------------------------------- mma

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------- B from f32, by pieces
// `at(k, n)`: the f32 operand at row k (within the chunk) and column n
// (within the 8-column tile).  Each transport computes its pieces' B
// fragments and runs one product a piece into d[piece].

template <typename At>
__device__ __forceinline__ void bf16x3(float d[3][4], const uint32_t a[4],
                                       At at) {
  const int g = frag_g(), t2 = 2 * frag_t();
  uint32_t q[4][3];
  split_bf16(at(t2, g), q[0]);
  split_bf16(at(t2 + 1, g), q[1]);
  split_bf16(at(t2 + 8, g), q[2]);
  split_bf16(at(t2 + 9, g), q[3]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mma_bf16(d[i], a, q[0][i] | (q[1][i] << 16), q[2][i] | (q[3][i] << 16));
  }
}

template <typename At>
__device__ __forceinline__ void tf32x3(float d[3][4], const uint32_t a[4],
                                       At at) {
  const int g = frag_g(), t = frag_t();
  uint32_t q0[3], q1[3];
  split_tf32(at(t, g), q0);
  split_tf32(at(t + 4, g), q1);
#pragma unroll
  for (int i = 0; i < 3; ++i) mma_tf32(d[i], a, q0[i], q1[i]);
}

// Four byte planes of the f32 bits: d[j] sums byte j.
template <typename At>
__device__ __forceinline__ void u8x4(int d[4][4], const uint32_t a[4],
                                     At at) {
  const int g = frag_g(), t4 = 4 * frag_t();
  uint32_t w0[4], w1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w0[i] = __float_as_uint(at(t4 + i, g));
    w1[i] = __float_as_uint(at(t4 + 16 + i, g));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b0 = 0, b1 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b0 |= ((w0[i] >> (8 * j)) & 255u) << (8 * i);
      b1 |= ((w1[i] >> (8 * j)) & 255u) << (8 * i);
    }
    mma_u8(d[j], a, b0, b1);
  }
}

// (t1 + t2) + t3 of the three pieces' products, entry e of the fragment.
__device__ __forceinline__ float join3(const float d[3][4], int e) {
  return __fadd_rn(__fadd_rn(d[0][e], d[1][e]), d[2][e]);
}

// The f32 whose bytes the four planes' sums hold, entry e.
__device__ __forceinline__ float join4(const int d[4][4], int e) {
  return __uint_as_float((d[0][e] & 255u) | ((d[1][e] & 255u) << 8) |
                         ((d[2][e] & 255u) << 16) |
                         ((d[3][e] & 255u) << 24));
}

}  // namespace onehot_mma
