// K3: attention-weighted sum over the epipolar samples of sample-major tokens.
//
// Replaces coponerf_tpu/ops/pallas/weighted_sum.py:weighted_sum_smaj
// (_kernel and _kernel_vsum).  Computes
//   out[b, n, :] = sum_v sum_s w[b*V+v, n, s] * pre[b*V+v, s*N + n, :]
// with f32 accumulation (V = 1 is the per-row form without the view sum).
//
// What bounds it on the H100: bytes.  Two FLOPs per activation element read
// once (~0.5 FLOP/byte in bf16), so the only goal is one pass over `pre` at
// full bandwidth.  One thread owns one 16-byte channel vector of one output
// token (neighbouring threads on neighbouring bytes of the same token row),
// loops over the V view rows and the S samples in registers, and writes its
// f32 sums once.  No atomics: the result is deterministic.  The summation
// order is the TPU kernel's: per view row over s, then over views.

#include "common.cuh"

namespace coponerf {

template <typename T>
__global__ void weighted_sum_kernel(const T* __restrict__ pre, const float* __restrict__ w,
                                    float* __restrict__ out, int Bo, int V, int S, int N, int C) {
  constexpr int VEC = Vec16<T>::N;
  const int nvec = C / VEC;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(Bo) * N * nvec;
  if (tid >= total) return;
  const long long bn = tid / nvec;
  const int v = static_cast<int>(tid - bn * nvec);
  const long long b = bn / N;
  const long long n = bn - b * N;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  for (int vv = 0; vv < V; ++vv) {
    const long long r = b * V + vv;
    const T* base = pre + (r * S * N + n) * C + static_cast<long long>(v) * VEC;
    const float* wr = w + (r * N + n) * S;
    float accv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) accv[e] = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float ws = wr[s];
      float x[VEC];
      load16(base + static_cast<long long>(s) * N * C, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) accv[e] = __fadd_rn(accv[e], __fmul_rn(x[e], ws));
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], accv[e]);
  }
  float* o = out + bn * C + static_cast<long long>(v) * VEC;
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    const float q[4] = {acc[e], acc[e + 1], acc[e + 2], acc[e + 3]};
    store16(o + e, q);
  }
}

template <typename T>
static int launch(const void* pre, const void* w, void* out, int Bo, int V, int S, int N, int C,
                  cudaStream_t stream) {
  const long long total = static_cast<long long>(Bo) * N * (C / Vec16<T>::N);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  weighted_sum_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(pre), static_cast<const float*>(w), static_cast<float*>(out), Bo, V,
      S, N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace coponerf

// R = Bo * V rows of pre (R, S*N, C) and w (R, N, S); out (Bo, N, C) f32
extern "C" int k3_weighted_sum(const void* pre, const void* w, void* out, int R, int V, int S,
                               int N, int C, int dtype, void* stream) {
  if (V <= 0 || R % V != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == coponerf::kBF16)
    return coponerf::launch<__nv_bfloat16>(pre, w, out, R / V, V, S, N, C, s);
  return coponerf::launch<float>(pre, w, out, R / V, V, S, N, C, s);
}
