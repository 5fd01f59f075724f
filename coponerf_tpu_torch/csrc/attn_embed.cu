// K7: the epipolar attention rounds' embed chains and logits.
//
// Replaces coponerf_tpu/ops/pallas/experimental/attn_embed.py:round1_logits
// (_round1_kernel) and :round2_logits (_round2_kernel).  Per token
//   round 1:  dot1 = sum(kv * ce) / 11.31,
//             kv = relu(ka + kbs + fkb) @ wk2 + bk2,
//             ce = relu(lc @ wq + bq) @ wq2 + bq2
//   round 2:  dot2 = sum(qre * ce) / 11.31,
//             qre = relu(ze @ wra + lc @ wrb + br) @ wr2 + br2
// with bf16 operands, f32 accumulation and f32 logits.  Round 2 tokens are
// sample-major (token s*N + n of view row r = b*V + v reads ray (b, n)'s ze).
//
// What bounds it on the H100: round 1 is bytes (ka and kbs, 512 B a token,
// against ~0.14 MFLOP a token); round 2 is operations (~0.15 MFLOP a token
// from 32 B of lc).  Round 1 reads each key row with 16-byte loads, a lane
// quad per row, on a permuted k axis of the key product whose A fragments
// those loads are (attn_chain.cuh).  Each warp runs its 16-token tile through the whole
// chain in registers (attn_chain.cuh): mma.sync m16n8k16 products whose f32
// accumulators become the next product's bf16 A fragments, and the dot per
// token reduced over a lane quad, so only the logits leave the chip.  The
// 128 x 128 and 16 x 128 weights sit in shared memory, staged once per block;
// the blocks are persistent (two per SM) and walk their tiles.  Round 2
// takes ze @ wra once per (b, 16-ray tile) and keeps it in registers across
// that tile's V * S token tiles, where the TPU kernel recomputed it per token.

#include "attn_chain.cuh"

namespace coponerf {

using namespace chain;

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
round1_kernel(const bf16* __restrict__ ka, const bf16* __restrict__ kbs, const bf16* __restrict__ lc,
              const float* __restrict__ fkb, const bf16* __restrict__ wk2t, const float* __restrict__ bk2,
              const bf16* __restrict__ wqt, const float* __restrict__ bq, const bf16* __restrict__ wq2t,
              const float* __restrict__ bq2, float* __restrict__ out, long long M) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_wk2 = reinterpret_cast<bf16*>(smem);
  bf16* s_wq2 = s_wk2 + H * LDH;
  bf16* s_wq = s_wq2 + H * LDH;
  float* s_b = reinterpret_cast<float*>(s_wq + H * LDL);  // fkb, bk2, bq, bq2
  stage_perm(s_wk2, wk2t);
  stage(s_wq2, wq2t, H, H);
  stage(s_wq, wqt, H, L);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    s_b[i] = fkb[i];
    s_b[H + i] = bk2[i];
    s_b[2 * H + i] = bq[i];
    s_b[3 * H + i] = bq2[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long tiles = (M + 15) / 16;
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp; tile < tiles;
       tile += static_cast<long long>(gridDim.x) * kWarps) {
    const long long ra = tile * 16 + g, rb = ra + 8;
    const bool va = ra < M, vb = rb < M;
    uint32_t lcA[4];
    load_lc(va ? lc + ra * L : nullptr, vb ? lc + rb * L : nullptr, lane, lcA);
    uint32_t hA[NK][4];
    hidden16<false>(lcA, s_wq, LDL, s_b + 2 * H, nullptr, lane, hA);

    // relu(ka + kbs + fkb) straight into A fragments of the permuted k axis
    // (attn_chain.cuh): the quad reads each key row once, 16 bytes a load
    uint32_t kA[NK][4];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const long long row = rs ? rb : ra;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c0 = 32 * t + 8 * q;
        uint4 a = make_uint4(0, 0, 0, 0), b = make_uint4(0, 0, 0, 0);
        if (rs ? vb : va) {
          a = __ldg(reinterpret_cast<const uint4*>(ka + row * H + c0));
          b = __ldg(reinterpret_cast<const uint4*>(kbs + row * H + c0));
        }
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = c0 + 2 * i;
          const float2 x = unpack(aw[i]), y = unpack(bw[i]);
          float x0 = fmaxf(x.x + y.x + s_b[col], 0.f), x1 = fmaxf(x.y + y.y + s_b[col + 1], 0.f);
          if (!(rs ? vb : va)) x0 = x1 = 0.f;
          kA[2 * q + (i >> 1)][(i & 1) * 2 + rs] = pack(x0, x1);
        }
      }
    }
    float s0, s1;
    dot_rows<NJ, true>(kA, s_wk2, s_b + H, hA, s_wq2, s_b + 3 * H, LDH, 0, lane, s0, s1);
    if (t == 0) {
      if (va) out[ra] = s0 * kInvScale;
      if (vb) out[rb] = s1 * kInvScale;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
round2_kernel(const float* __restrict__ ze, const bf16* __restrict__ lc, const bf16* __restrict__ wqt,
              const float* __restrict__ bq, const bf16* __restrict__ wq2t, const float* __restrict__ bq2,
              const bf16* __restrict__ wrat, const bf16* __restrict__ wrbt, const float* __restrict__ br,
              const bf16* __restrict__ wr2t, const float* __restrict__ br2, float* __restrict__ out,
              int B, int V, int S, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_wq2 = reinterpret_cast<bf16*>(smem);
  bf16* s_wr2 = s_wq2 + H * LDH;
  bf16* s_wq = s_wr2 + H * LDH;
  bf16* s_wrb = s_wq + H * LDL;
  float* s_b = reinterpret_cast<float*>(s_wrb + H * LDL);  // bq, bq2, br, br2
  stage(s_wq2, wq2t, H, H);
  stage(s_wr2, wr2t, H, H);
  stage(s_wq, wqt, H, L);
  stage(s_wrb, wrbt, H, L);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    s_b[i] = bq[i];
    s_b[H + i] = bq2[i];
    s_b[2 * H + i] = br[i];
    s_b[3 * H + i] = br2[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (N + 15) / 16;
  const long long units = static_cast<long long>(B) * ntiles;
  const long long T = static_cast<long long>(S) * N;
  for (long long unit = static_cast<long long>(blockIdx.x) * kWarps + warp; unit < units;
       unit += static_cast<long long>(gridDim.x) * kWarps) {
    const int b = static_cast<int>(unit / ntiles);
    const int na = static_cast<int>(unit - static_cast<long long>(b) * ntiles) * 16 + g, nb = na + 8;
    const bool va = na < N, vb = nb < N;

    // zw = bf16(ze) @ wra for the tile's 16 rays, once for all V * S tokens
    float zw[NJ][4];
    {
      uint32_t zA[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = kk * 16 + half * 8 + 2 * t;
#pragma unroll
          for (int rs = 0; rs < 2; ++rs) {
            float2 z = make_float2(0.f, 0.f);
            if (rs ? vb : va)
              z = __ldg(reinterpret_cast<const float2*>(ze + (static_cast<long long>(b) * N + (rs ? nb : na)) * H + col));
            zA[kk][half * 2 + rs] = pack(z.x, z.y);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) zw[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const bf16* p = wrat + (j * 8 + g) * H + kk * 16 + 2 * t;
          mma(zw[j], zA[kk], ldg32(p), ldg32(p + 8));
        }
      }
    }

    for (int v = 0; v < V; ++v) {
      const long long r = static_cast<long long>(b) * V + v;
      for (int s = 0; s < S; ++s) {
        const long long ta = r * T + static_cast<long long>(s) * N + na, tb = ta + 8;
        uint32_t lcA[4];
        load_lc(va ? lc + ta * L : nullptr, vb ? lc + tb * L : nullptr, lane, lcA);
        uint32_t hA[NK][4], qA[NK][4];
        hidden16<false>(lcA, s_wq, LDL, s_b, nullptr, lane, hA);
        hidden16<true>(lcA, s_wrb, LDL, s_b + 2 * H, &zw[0][0], lane, qA);
        float s0, s1;
        dot_rows<NJ>(qA, s_wr2, s_b + 3 * H, hA, s_wq2, s_b + H, LDH, 0, lane, s0, s1);
        if (t == 0) {
          if (va) out[ta] = s0 * kInvScale;
          if (vb) out[tb] = s1 * kInvScale;
        }
      }
    }
  }
}

static int persistent_blocks(long long work_items, int per_block) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (work_items + per_block - 1) / per_block;
  const long long cap = 2LL * (sms > 0 ? sms : 1);
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace coponerf

// ka, kbs (M, 128) bf16; lc (M, 16) bf16; weights transposed (out x in)
// bf16; biases f32; out (M,) f32
extern "C" int k7_round1_logits(const void* ka, const void* kbs, const void* lc, const void* fkb,
                                const void* wk2t, const void* bk2, const void* wqt, const void* bq,
                                const void* wq2t, const void* bq2, void* out, long long M, void* stream) {
  using namespace coponerf;
  if (M == 0) return 0;
  const size_t bytes = (2 * H * LDH + H * LDL) * sizeof(bf16) + 4 * H * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(round1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = persistent_blocks((M + 15) / 16, kWarps);
  round1_kernel<<<blocks, kWarps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(ka), static_cast<const bf16*>(kbs), static_cast<const bf16*>(lc),
      static_cast<const float*>(fkb), static_cast<const bf16*>(wk2t), static_cast<const float*>(bk2),
      static_cast<const bf16*>(wqt), static_cast<const float*>(bq), static_cast<const bf16*>(wq2t),
      static_cast<const float*>(bq2), static_cast<float*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

// ze (B, N, 128) f32; lc (B*V, S*N, 16) bf16 sample-major; out (B*V, S*N) f32
extern "C" int k7_round2_logits(const void* ze, const void* lc, const void* wqt, const void* bq,
                                const void* wq2t, const void* bq2, const void* wrat, const void* wrbt,
                                const void* br, const void* wr2t, const void* br2, void* out, int B, int V,
                                int S, int N, void* stream) {
  using namespace coponerf;
  if (static_cast<long long>(B) * V * S * N == 0) return 0;
  const size_t bytes = (2 * H * LDH + 2 * H * LDL) * sizeof(bf16) + 4 * H * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(round2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = persistent_blocks(static_cast<long long>(B) * ((N + 15) / 16), kWarps);
  round2_kernel<<<blocks, kWarps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ze), static_cast<const bf16*>(lc), static_cast<const bf16*>(wqt),
      static_cast<const float*>(bq), static_cast<const bf16*>(wq2t), static_cast<const float*>(bq2),
      static_cast<const bf16*>(wrat), static_cast<const bf16*>(wrbt), static_cast<const float*>(br),
      static_cast<const bf16*>(wr2t), static_cast<const float*>(br2), static_cast<float*>(out), B, V, S, N);
  return static_cast<int>(cudaGetLastError());
}
