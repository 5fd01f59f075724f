// Register-level pieces of the epipolar attention chains: K6's mma.sync
// chains, and the widths, bf16 packing and lc loads that K7 shares.
//
// One warp owns a 16-token tile and runs a 128-wide embed chain on it with
// mma.sync m16n8k16 (bf16 in, f32 accumulate).  The f32 accumulator of two
// neighbouring 8-column tiles has exactly the layout of one 16-deep bf16 A
// fragment, so a hidden layer goes from one product into the next without
// leaving the registers: nothing 128 wide is written anywhere.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A (16 x 16, row)  a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   B (16 x 8, col)   b0: (k 2t..2t+1, n g)  b1: (k 2t+8.., n g)
//   C (16 x 8, f32)   c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..2t+1)
// Weights are held transposed (out x in, bf16) so that b0 and b1 are single
// 32-bit words; a row stride of in + 8 makes the 32 lanes' words fall in 32
// distinct shared-memory banks.
#pragma once

#include "common.cuh"

namespace coponerf {
namespace chain {

using bf16 = __nv_bfloat16;

constexpr int H = 128;          // embed width
constexpr int L = 16;           // local-coordinate width
constexpr int LDH = H + 8;      // row stride of a transposed 128-deep weight
constexpr int LDL = L + 8;      // row stride of a transposed 16-deep weight
constexpr int NJ = H / 8;       // 8-column output tiles of a 128-wide product
constexpr int NK = H / 16;      // 16-deep k-blocks of a 128-deep product
constexpr float kInvScale = static_cast<float>(1.0 / 11.31);

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// d += A (16 x 16) B (16 x 8)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of output tile j, k-block kk, from a transposed weight
// (out x in, row stride ld) in shared or global memory
__device__ __forceinline__ void ldb(const bf16* wt, int ld, int j, int kk, int lane, uint32_t& b0,
                                    uint32_t& b1) {
  const bf16* p = wt + (j * 8 + (lane >> 2)) * ld + kk * 16 + (lane & 3) * 2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// A fragment set of a 128-wide hidden layer from an f32 accumulator, in
// place of the accumulator's 8-column tiles: hA[j / 2][(j % 2) * 2 + {0, 1}]
__device__ __forceinline__ void put(uint32_t (&hA)[NK][4], int j, float x0, float x1, float x2,
                                    float x3) {
  hA[j >> 1][(j & 1) * 2] = pack(x0, x1);
  hA[j >> 1][(j & 1) * 2 + 1] = pack(x2, x3);
}

// hA = relu(lc @ W + b): the 16-deep first layer of a coordinate embed.
// acc0 (optional, NJ x 4 floats in the accumulator layout) is an f32 term
// the product is added to, as in relu(ze @ Wa + lc @ Wb + b); the bias is
// added after the products.
template <bool kAcc>
__device__ __forceinline__ void hidden16(const uint32_t (&lcA)[4], const bf16* wt, int ldw, const float* b,
                                         const float* acc0, int lane, uint32_t (&hA)[NK][4]) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (kAcc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = acc0[j * 4 + e];
    }
    uint32_t b0, b1;
    ldb(wt, ldw, j, 0, lane, b0, b1);
    mma(d, lcA, b0, b1);
    const int col = j * 8 + 2 * t;
    const float b_0 = b[col], b_1 = b[col + 1];
    put(hA, j, fmaxf(d[0] + b_0, 0.f), fmaxf(d[1] + b_1, 0.f), fmaxf(d[2] + b_0, 0.f),
        fmaxf(d[3] + b_1, 0.f));
  }
}

// Per-row logit partials of sum_c (P @ WP + bP)[c] * (Q @ WQ + bQ)[c] over
// the output tiles j0 .. j0 + kTiles - 1, for the tile's rows g (s0) and
// g + 8 (s1), reduced over the lane quad: every lane of a quad returns the
// rows' sums.  ld is the row stride of both transposed weights.
template <int kTiles>
__device__ __forceinline__ void dot_rows(const uint32_t (&pA)[NK][4], const bf16* wp, const float* bp,
                                         const uint32_t (&qA)[NK][4], const bf16* wq, const float* bq,
                                         int ld, int j0, int lane, float& s0, float& s1) {
  const int t = lane & 3;
  s0 = 0.f;
  s1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < kTiles; ++jj) {
    const int j = j0 + jj;
    float p[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t b0, b1;
      ldb(wp, ld, j, kk, lane, b0, b1);
      mma(p, pA[kk], b0, b1);
      ldb(wq, ld, j, kk, lane, b0, b1);
      mma(q, qA[kk], b0, b1);
    }
    const int col = j * 8 + 2 * t;
    s0 += (p[0] + bp[col]) * (q[0] + bq[col]) + (p[1] + bp[col + 1]) * (q[1] + bq[col + 1]);
    s1 += (p[2] + bp[col]) * (q[2] + bq[col]) + (p[3] + bp[col + 1]) * (q[3] + bq[col + 1]);
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
}

// A fragment of a 16 x 16 bf16 tile whose rows ra / rb (nullptr: zero row)
// are contiguous 16-wide bf16 vectors
__device__ __forceinline__ void load_lc(const bf16* ra, const bf16* rb, int lane, uint32_t (&a)[4]) {
  const int t = lane & 3;
  a[0] = ra ? ldg32(ra + 2 * t) : 0u;
  a[1] = rb ? ldg32(rb + 2 * t) : 0u;
  a[2] = ra ? ldg32(ra + 8 + 2 * t) : 0u;
  a[3] = rb ? ldg32(rb + 8 + 2 * t) : 0u;
}

}  // namespace chain
}  // namespace coponerf
