// K1: bilinear sampling of a flat latent table at [-1, 1] (x, y) points.
//
// Replaces coponerf_tpu/ops/pallas/bilinear_sample.py:onehot_matmul_sample_xy
// (the banded one-hot selection matmul, reached through grid_sample_onehot)
// and, for the 256^2 level, the XLA patch gather of ops/grid_sample.py.
//
// What bounds it on the H100: bytes.  Each point reads 4 corner rows of C
// channels and writes one row; there is no reuse to feed a tensor core.  The
// TPU built a one-hot matrix because its gather engine was slow; Hopper's
// load path gathers 16-byte vectors directly, so this kernel is a direct
// 4-corner gather: one thread per 16-byte channel vector of one point,
// neighbouring threads on neighbouring bytes of the same table row, corner
// weights in f32 from the same pixel coordinates as the plain version
// (ops/grid_sample.py), f32 blend, one 16-byte store.  Tables and output
// are bf16 (the fast path's only use; the exact path samples with the f32
// gather of ops/grid_sample.py, as the JAX package does).
// Epipolar points of consecutive rays land on nearby rows, so most corner
// reads hit L2.
//
// Padding: border clamps the coordinates into [0, size-1-1e-5]; zeros
// scrubs NaN/Inf to the +-3e4 clip, shifts by 2 (the JAX zero-ring
// convention, so weights are bit-identical) and reads a corner only when
// 0 <= xi < W and 0 <= yi < H (all four bounds).

#include "common.cuh"

namespace coponerf {

using bf16 = __nv_bfloat16;

__global__ void bilinear_sample_kernel(const bf16* __restrict__ table, const float* __restrict__ grid,
                                       bf16* __restrict__ out, int B, int H, int W, int C,
                                       long long P, int zeros_mode) {
  constexpr int VEC = Vec16<bf16>::N;
  const int nvec = C / VEC;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(B) * P * nvec;
  if (tid >= total) return;
  const long long bp = tid / nvec;
  const int v = static_cast<int>(tid - bp * nvec);
  const long long b = bp / P;

  const float gx = grid[2 * bp];
  const float gy = grid[2 * bp + 1];
  // _unnormalize (align_corners=False), without FMA contraction
  float x = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.0f), static_cast<float>(W)), 1.0f), 0.5f);
  float y = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.0f), static_cast<float>(H)), 1.0f), 0.5f);
  int shift = 0;
  if (zeros_mode) {
    const float clip = 3.0e4f;
    x = isnan(x) ? -clip : fminf(fmaxf(x, -clip), clip);
    y = isnan(y) ? -clip : fminf(fmaxf(y, -clip), clip);
    x = __fadd_rn(x, 2.0f);
    y = __fadd_rn(y, 2.0f);
    shift = 2;
  } else {
    x = fminf(fmaxf(x, 0.0f), static_cast<float>(static_cast<double>(W) - 1.0 - 1e-5));
    y = fminf(fmaxf(y, 0.0f), static_cast<float>(static_cast<double>(H) - 1.0 - 1e-5));
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f);
  const float wy = __fsub_rn(y, y0f);
  const int x0 = static_cast<int>(x0f) - shift;
  const int y0 = static_cast<int>(y0f) - shift;
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);
  const float wc[4] = {__fmul_rn(ux, uy), __fmul_rn(wx, uy), __fmul_rn(ux, wy), __fmul_rn(wx, wy)};

  const bf16* base = table + static_cast<long long>(b) * H * W * C + static_cast<long long>(v) * VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int xi = x0 + (c & 1);
    const int yi = y0 + (c >> 1);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    float val[VEC];
    load16(base + (static_cast<long long>(yi) * W + xi) * C, val);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(val[e], wc[c]));
  }
  store16(out + bp * C + static_cast<long long>(v) * VEC, acc);
}

}  // namespace coponerf

// table (B, H, W, C) bf16, grid (B, P, 2) f32, out (B, P, C) bf16
extern "C" int k1_bilinear_sample(const void* table, const void* grid, void* out, int B, int H,
                                  int W, int C, long long P, int zeros_mode, void* stream) {
  using coponerf::bf16;
  const long long total = static_cast<long long>(B) * P * (C / coponerf::Vec16<bf16>::N);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  coponerf::bilinear_sample_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(table), static_cast<const float*>(grid), static_cast<bf16*>(out), B, H,
      W, C, P, zeros_mode);
  return static_cast<int>(cudaGetLastError());
}
