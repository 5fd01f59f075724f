// K4: the sampler's backward, a scatter-add of point cotangents into the
// table gradient.
//
//   dtable[b, idx[b,p,c], :] += w[b,p,c] * g[b,p,:]   over the 4 corners c
//
// Replaces coponerf_tpu/ops/pallas/bilinear_sample.py:onehot_transpose_matmul
// (the dense one-hot transpose matmul M^T @ g, built per (hw-block, p-block)
// in VMEM and accumulated over point blocks on the MXU).  The TPU had no
// fast scatter, so it multiplied by a mostly-zero matrix; Hopper has
// hardware float atomics in L2, so this kernel is a direct scatter into an
// f32 output the wrapper zeroes.  One warp per point: every lane reads the
// point's 4 corner ids and weights (one broadcast load each), lane l owns
// channels l, l+32, l+64, ..., so each warp-wide f32 RED (atomic add, no
// return value) covers 32 consecutive floats, one 128-byte line.  Corners
// with idx < 0, idx >= HW or w == 0 are skipped.
//
// What bounds it on the H100: bytes in principle (g read once, the table
// gradient written once), but the adds of points that share a corner
// serialise in L2.  At the 16^2 level 49k corner updates per row land on
// 256 positions, so contention, not bandwidth, sets its time.  (A first
// layout, one thread per 8 consecutive channels, scattered each warp-wide
// RED over 32 sectors and ran 1.7-3.4x slower; PERF.md.)
//
// The f32 sums are taken in the order the atomics reach L2, which varies
// from run to run: the result's low bits are not reproducible, and the
// kernel is held to its plain version (ops/bilinear_sample.py,
// index_add_ in f32) with a tolerance.  The plain version on the CPU is
// deterministic.

#include "common.cuh"

namespace coponerf {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void transpose_sample_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                                        const float* __restrict__ w, float* __restrict__ out,
                                        long long BP, long long P, int HW, int C) {
  const long long bp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (bp >= BP) return;
  const long long b = bp / P;
  const int4 id4 = *reinterpret_cast<const int4*>(idx + 4 * bp);
  const float4 w4 = *reinterpret_cast<const float4*>(w + 4 * bp);
  const int ids[4] = {id4.x, id4.y, id4.z, id4.w};
  const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
  const T* gp = g + bp * C;
  float* base = out + b * HW * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    if (c >= C) break;
    const float gv = to_f32(gp[c]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (ids[k] < 0 || ids[k] >= HW || ws[k] == 0.0f) continue;
      atomicAdd(base + static_cast<long long>(ids[k]) * C + c, ws[k] * gv);
    }
  }
}

}  // namespace coponerf

// g (B, P, C) f32 or bf16, idx (B, P, 4) i32, w (B, P, 4) f32,
// out (B, HW, C) f32 zeroed by the caller
extern "C" int k4_transpose_sample(const void* g, const void* idx, const void* w, void* out, int B,
                                   long long P, int HW, int C, int g_dtype, void* stream) {
  const long long BP = static_cast<long long>(B) * P;
  if (BP == 0 || C == 0) return 0;
  const int threads = 256;  // 8 points per block, one warp each
  const unsigned blocks = static_cast<unsigned>((BP * 32 + threads - 1) / threads);
  auto s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (g_dtype == coponerf::kBF16) {
    coponerf::transpose_sample_kernel<coponerf::bf16><<<blocks, threads, 0, s>>>(
        static_cast<const coponerf::bf16*>(g), i, wt, o, BP, P, HW, C);
  } else {
    coponerf::transpose_sample_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(g), i, wt, o, BP, P, HW, C);
  }
  return static_cast<int>(cudaGetLastError());
}
