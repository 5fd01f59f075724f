// K5: the fused dual-axis soft-argmax over a flat correlation volume c
// (B, Q, S) f32, forward statistics and backward.
//
// Replaces coponerf_tpu/ops/pallas/soft_argmax.py: _stats (kernel
// _fwd_kernel) and _bwd (kernel _bwd_kernel).  With x/y the row-major grid
// coordinates in [-1, 1] of the s (xs, ys) and q (xq, yq) tokens:
//
//   row q:    m1 = max_s c,  z1 = sum_s e1,  sum_s e1*xs,  sum_s e1*ys,
//             e1 = exp((c[q,s] - m1) / beta)
//   column s: m2 = max_q c,  z2 = sum_q e2,  sum_q e2*xq,  sum_q e2*yq,
//             e2 = exp((c[q,s] - m2) / beta)
//   dc[q,s] = e1/z1 * ((xs-gx1)*dgx1 + (ys-gy1)*dgy1) / beta
//           + e2/z2 * ((xq-gx2)*dgx2 + (yq-gy2)*dgy2) / beta
//
// What bounds it on the H100: bytes.  The forward reads the volume once
// (402.7 MB at B 6, Q = S = 4096: 0.120 ms at 3.35 TB/s) for about 16
// operations an element; the backward reads it and writes dc (0.240 ms).
//
// Design.  The TPU kernel carried the column statistics from q-block to
// q-block on a sequential grid axis.  Blocks on Hopper run in no order, so
// the forward splits both reductions instead: the statistics merge
// associatively (m = max(ma, mb), z = za*e^((ma-m)/beta) + zb*e^((mb-m)/beta),
// the same rescale for the coordinate sums).  Pass 1 tiles (Q, S) into
// 64 x 256 tiles; a block reads its tile once with 16-byte loads into
// registers (warp w owns rows w, w+8, ...; lane l columns 4l..4l+3 and
// 128+4l..128+4l+3, so each warp load is 512 contiguous bytes) and writes
// the row partials over its 256 columns (warp shuffles) and the column
// partials over its 64 rows (a max, then sums, across warps in shared
// memory).  Pass 2 merges the S/256 partials of every row and the Q/64 of
// every column.  The partials are 16 bytes per entry, Q*S/256 + S*Q/64
// entries per batch (5.2 MB at Q = S = 4096, 1.3 % of the volume).  The
// backward is one elementwise pass: each block stages its 64 rows'
// statistics and cotangents in shared memory, each thread keeps its 4
// columns' in registers and streams 16 bytes of c in and 16 bytes of dc out
// per row.  exp((v-m)/beta) is exp2f((v-m) * log2(e)/beta).  Every sum has
// a fixed order, so results are reproducible run to run.  Ragged edges
// (Q, S not multiples of the tile, S not a multiple of 4) are masked.

#include <math.h>

#include "common.cuh"

namespace coponerf {

constexpr int kTQ = 64;              // pass 1 tile rows
constexpr int kTS = 256;             // pass 1 tile columns
constexpr int kWarps = 8;            // 256 threads
constexpr int kRowsPerWarp = kTQ / kWarps;
constexpr int kBTQ = 64;             // backward tile rows
constexpr int kBTS = 256;            // backward tile columns: 64 threads x 4
constexpr double kLog2e = 1.4426950408889634;

// four consecutive values of one row starting at column s0; missing ones
// (s >= S) read as -inf, which every max ignores and every exp maps to 0
__device__ __forceinline__ void load4(const float* row, int s0, int S, bool vec, float (&v)[4]) {
  if (vec && s0 + 3 < S) {
    load16(row + s0, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = s0 + e < S ? row[s0 + e] : -INFINITY;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// pass 1: rowp (B, nSB, 4, Q) and colp (B, nQB, 4, S) partial statistics
__global__ void __launch_bounds__(kWarps * 32)
    soft_argmax_partials_kernel(const float* __restrict__ c, const float* __restrict__ xs,
                                const float* __restrict__ ys, const float* __restrict__ xq,
                                const float* __restrict__ yq, float* __restrict__ rowp,
                                float* __restrict__ colp, int Q, int S, float k, bool vec) {
  __shared__ float colmax[kWarps][kTS];
  __shared__ float colsum[3][kWarps][kTS];
  const int sb = blockIdx.x, qb = blockIdx.y, b = blockIdx.z;
  const int nSB = gridDim.x, nQB = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s0 = sb * kTS, q0 = qb * kTQ;
  const float* cb = c + static_cast<long long>(b) * Q * S;

  // the lane's 8 columns (tile-local): 4*lane + j and 128 + 4*lane + j
  int col[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) col[j] = (j < 4 ? 4 * lane : 128 + 4 * lane) + (j & 3);
  float v[kRowsPerWarp][8];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int q = q0 + warp + kWarps * i;
    float a[4], bb[4];
    if (q < Q) {
      const float* row = cb + static_cast<long long>(q) * S;
      load4(row, s0 + col[0], S, vec, a);
      load4(row, s0 + col[4], S, vec, bb);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = bb[e] = -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[i][e] = a[e];
      v[i][4 + e] = bb[e];
    }
  }
  float xc[8], yc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = s0 + col[j];
    xc[j] = s < S ? xs[s] : 0.0f;
    yc[j] = s < S ? ys[s] : 0.0f;
  }

  // row partials over this tile's columns: one warp per row
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float m = v[i][0];
#pragma unroll
    for (int j = 1; j < 8; ++j) m = fmaxf(m, v[i][j]);
    m = warp_max(m);
    float z = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e = exp2f((v[i][j] - m) * k);
      z += e;
      sx = fmaf(e, xc[j], sx);
      sy = fmaf(e, yc[j], sy);
    }
    z = warp_sum(z);
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    const int q = q0 + warp + kWarps * i;
    if (lane == 0 && q < Q) {
      float* p = rowp + (static_cast<long long>(b) * nSB + sb) * 4 * Q + q;
      p[0] = m;
      p[Q] = z;
      p[2 * Q] = sx;
      p[3 * Q] = sy;
    }
  }

  // column partials over this tile's rows: the max first, then the sums
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float m = v[0][j];
#pragma unroll
    for (int i = 1; i < kRowsPerWarp; ++i) m = fmaxf(m, v[i][j]);
    colmax[warp][col[j]] = m;
  }
  __syncthreads();
  float M[8], z2[8], sx2[8], sy2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float m = colmax[0][col[j]];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, colmax[w][col[j]]);
    M[j] = m;
    z2[j] = sx2[j] = sy2[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int q = q0 + warp + kWarps * i;
    const float xqi = q < Q ? xq[q] : 0.0f;
    const float yqi = q < Q ? yq[q] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e = exp2f((v[i][j] - M[j]) * k);
      z2[j] += e;
      sx2[j] = fmaf(e, xqi, sx2[j]);
      sy2[j] = fmaf(e, yqi, sy2[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    colsum[0][warp][col[j]] = z2[j];
    colsum[1][warp][col[j]] = sx2[j];
    colsum[2][warp][col[j]] = sy2[j];
  }
  __syncthreads();
  const int t = threadIdx.x;  // one thread per tile column
  const int s = s0 + t;
  if (s < S) {
    float m = colmax[0][t];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, colmax[w][t]);
    float sums[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float acc = 0.0f;
      for (int w = 0; w < kWarps; ++w) acc += colsum[r][w][t];
      sums[r] = acc;
    }
    float* p = colp + (static_cast<long long>(b) * nQB + qb) * 4 * S + s;
    p[0] = m;
    p[S] = sums[0];
    p[2 * S] = sums[1];
    p[3 * S] = sums[2];
  }
}

// pass 2: merge the partials of every row (B*Q threads) and every column
// (B*S threads) into row (B, 4, Q) and col (B, 4, S)
__global__ void soft_argmax_combine_kernel(const float* __restrict__ rowp,
                                           const float* __restrict__ colp, float* __restrict__ row,
                                           float* __restrict__ col, int B, int Q, int S, int nSB,
                                           int nQB, float k) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float* p;
  float* out;
  int n, parts;
  if (t < static_cast<long long>(B) * Q) {
    const long long b = t / Q, i = t - b * Q;
    p = rowp + b * nSB * 4 * Q + i;
    out = row + b * 4 * Q + i;
    n = Q;
    parts = nSB;
  } else {
    t -= static_cast<long long>(B) * Q;
    if (t >= static_cast<long long>(B) * S) return;
    const long long b = t / S, i = t - b * S;
    p = colp + b * nQB * 4 * S + i;
    out = col + b * 4 * S + i;
    n = S;
    parts = nQB;
  }
  const long long stride = 4LL * n;
  float m = -INFINITY;
  for (int j = 0; j < parts; ++j) m = fmaxf(m, p[j * stride]);
  float z = 0.0f, sx = 0.0f, sy = 0.0f;
  for (int j = 0; j < parts; ++j) {
    const float* pj = p + j * stride;
    const float f = exp2f((pj[0] - m) * k);
    z = fmaf(pj[n], f, z);
    sx = fmaf(pj[2 * n], f, sx);
    sy = fmaf(pj[3 * n], f, sy);
  }
  out[0] = m;
  out[n] = z;
  out[2 * n] = sx;
  out[3 * n] = sy;
}

// backward: dc (B, Q, S) from c, the finalized row (B, 4, Q) and column
// (B, 4, S) statistics (m, z, gx, gy) and the cotangents dr (B, 2, Q) and
// dcol (B, 2, S)
__global__ void __launch_bounds__(256)
    soft_argmax_bwd_kernel(const float* __restrict__ c, const float* __restrict__ rowf,
                           const float* __restrict__ colf, const float* __restrict__ dr,
                           const float* __restrict__ dcol, const float* __restrict__ xs,
                           const float* __restrict__ ys, const float* __restrict__ xq,
                           const float* __restrict__ yq, float* __restrict__ out, int Q, int S,
                           float k, float inv_b, bool vec) {
  // per row: m1, 1/z1, gx1, gy1, dgx1, dgy1, xq, yq
  __shared__ float rs[8][kBTQ];
  const int sb = blockIdx.x, qb = blockIdx.y, b = blockIdx.z;
  const int s0 = sb * kBTS + 4 * (threadIdx.x % 64), q0 = qb * kBTQ;
  const long long bQ = static_cast<long long>(b) * Q, bS = static_cast<long long>(b) * S;
  if (threadIdx.x < kBTQ) {
    const int r = threadIdx.x, q = q0 + r;
    if (q < Q) {
      const float* f = rowf + 4 * bQ + q;
      rs[0][r] = f[0];
      rs[1][r] = 1.0f / f[Q];
      rs[2][r] = f[2 * Q];
      rs[3][r] = f[3 * Q];
      rs[4][r] = dr[2 * bQ + q];
      rs[5][r] = dr[2 * bQ + Q + q];
      rs[6][r] = xq[q];
      rs[7][r] = yq[q];
    }
  }
  // the thread's 4 columns: m2, 1/z2, gx2, gy2, dgx2, dgy2, xs, ys
  float m2[4], iz2[4], gx2[4], gy2[4], dgx2[4], dgy2[4], xc[4], yc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int s = s0 + e;
    const bool ok = s < S;
    const float* f = colf + 4 * bS + s;
    m2[e] = ok ? f[0] : 0.0f;
    iz2[e] = ok ? 1.0f / f[S] : 0.0f;
    gx2[e] = ok ? f[2 * S] : 0.0f;
    gy2[e] = ok ? f[3 * S] : 0.0f;
    dgx2[e] = ok ? dcol[2 * bS + s] : 0.0f;
    dgy2[e] = ok ? dcol[2 * bS + S + s] : 0.0f;
    xc[e] = ok ? xs[s] : 0.0f;
    yc[e] = ok ? ys[s] : 0.0f;
  }
  __syncthreads();
  if (s0 >= S) return;
  const float* cb = c + bQ * S;
  float* ob = out + bQ * S;
  const bool full = vec && s0 + 3 < S;
#pragma unroll 4
  for (int r = threadIdx.x / 64; r < kBTQ; r += 4) {
    const int q = q0 + r;
    if (q >= Q) break;
    const float m1 = rs[0][r], iz1 = rs[1][r], gx1 = rs[2][r], gy1 = rs[3][r];
    const float dgx1 = rs[4][r], dgy1 = rs[5][r], xqr = rs[6][r], yqr = rs[7][r];
    float v[4], o[4];
    load4(cb + static_cast<long long>(q) * S, s0, S, vec, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p1 = exp2f((v[e] - m1) * k) * iz1;
      const float p2 = exp2f((v[e] - m2[e]) * k) * iz2[e];
      const float t1 = (xc[e] - gx1) * dgx1 + (yc[e] - gy1) * dgy1;
      const float t2 = (xqr - gx2[e]) * dgx2[e] + (yqr - gy2[e]) * dgy2[e];
      o[e] = (p1 * t1 + p2 * t2) * inv_b;
    }
    float* orow = ob + static_cast<long long>(q) * S + s0;
    if (full) {
      store16(orow, o);
    } else {
      for (int e = 0; e < 4 && s0 + e < S; ++e) orow[e] = o[e];
    }
  }
}

}  // namespace coponerf

// c (B, Q, S) f32; xs, ys (S,) and xq, yq (Q,) coordinates; scratch rowp
// (B, nSB, 4, Q) and colp (B, nQB, 4, S); out row (B, 4, Q), col (B, 4, S)
extern "C" int k5_soft_argmax_stats(const void* c, const void* xs, const void* ys, const void* xq,
                                    const void* yq, void* rowp, void* colp, void* row, void* col,
                                    int B, int Q, int S, int nSB, int nQB, double beta,
                                    void* stream) {
  using namespace coponerf;
  if (B <= 0 || Q <= 0 || S <= 0) return 0;
  if (nSB != (S + kTS - 1) / kTS || nQB != (Q + kTQ - 1) / kTQ || nQB > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float k = static_cast<float>(kLog2e / beta);
  const float* cf = static_cast<const float*>(c);
  const bool vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(cf) % 16 == 0;
  soft_argmax_partials_kernel<<<dim3(nSB, nQB, B), kWarps * 32, 0, s>>>(
      cf, static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(xq), static_cast<const float*>(yq), static_cast<float*>(rowp),
      static_cast<float*>(colp), Q, S, k, vec);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long n = static_cast<long long>(B) * (Q + S);
  const int threads = 256;
  soft_argmax_combine_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(rowp), static_cast<const float*>(colp), static_cast<float*>(row),
      static_cast<float*>(col), B, Q, S, nSB, nQB, k);
  return static_cast<int>(cudaGetLastError());
}

// c (B, Q, S) f32, rowf (B, 4, Q), colf (B, 4, S), dr (B, 2, Q),
// dcol (B, 2, S), coordinates as above; out dc (B, Q, S) f32
extern "C" int k5_soft_argmax_bwd(const void* c, const void* rowf, const void* colf, const void* dr,
                                  const void* dcol, const void* xs, const void* ys, const void* xq,
                                  const void* yq, void* out, int B, int Q, int S, double beta,
                                  void* stream) {
  using namespace coponerf;
  if (B <= 0 || Q <= 0 || S <= 0) return 0;
  const int nSB = (S + kBTS - 1) / kBTS, nQB = (Q + kBTQ - 1) / kBTQ;
  if (nQB > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float k = static_cast<float>(kLog2e / beta);
  const float inv_b = static_cast<float>(1.0 / beta);
  const float* cf = static_cast<const float*>(c);
  float* of = static_cast<float*>(out);
  const bool vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(cf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(of) % 16 == 0;
  soft_argmax_bwd_kernel<<<dim3(nSB, nQB, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      cf, static_cast<const float*>(rowf), static_cast<const float*>(colf),
      static_cast<const float*>(dr), static_cast<const float*>(dcol),
      static_cast<const float*>(xs), static_cast<const float*>(ys), static_cast<const float*>(xq),
      static_cast<const float*>(yq), of, Q, S, k, inv_b, vec);
  return static_cast<int>(cudaGetLastError());
}
