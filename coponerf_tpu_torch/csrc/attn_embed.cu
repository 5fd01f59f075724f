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
// from 32 B of lc).
//
// Round 1 (round1_kernel) reads each key row with 16-byte loads, a lane
// quad per row, on a permuted k axis of the key product whose A fragments
// those loads are (attn_chain.cuh).  Each warp runs its 16-token tile
// through the whole chain in registers (attn_chain.cuh): mma.sync m16n8k16
// products whose f32 accumulators become the next product's bf16 A
// fragments, and the dot per token reduced over a lane quad, so only the
// logits leave the chip.  The 128 x 128 and 16 x 128 weights sit in shared
// memory, staged once per block; the blocks are persistent (two per SM)
// and walk their tiles.
//
// Round 2 (round2_kernel, below) runs on Hopper's register-A wgmma: a
// warpgroup takes 64-token tiles, whose products read B from shared memory
// without the per-mma fragment loads mma.sync needs, and takes ze @ wra
// once per 64 rays for all their V * S token tiles, where the TPU kernel
// recomputed it per token.

#include "attn_chain.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------- round 2 --
namespace r2 {

constexpr int kWG = 2;                      // warpgroups a block, each on its own 64-ray units
constexpr int kThreads = 128 * kWG;
constexpr int kRays = 64;                   // rays a unit: the wgmma tile's M
constexpr int kW128 = H * H * 2;            // a 128 x 128 bf16 weight: two 64-deep K slabs of 128 rows x 128 B
constexpr int kW16 = H * 128;               // a 16-deep weight in one slab (k 16.. unused)
constexpr int kZw = kRays * H * 4;          // a warpgroup's zw, f32
constexpr size_t kSmem = 1024 + 3 * kW128 + 2 * kW16 + 4 * H * 4 + kWG * kZw;

// a weight in its (K, 128) f32 layout (K = 16 or 128), rounded to bf16,
// into K-major 128-byte swizzled slabs: the 16-byte chunk c (k = 8c ..
// 8c + 7) of output column n's 64-deep slab at n * 128 + ((c ^ n % 8) << 4)
__device__ __forceinline__ void stage_sw128(unsigned char* dst, const float* __restrict__ src, int K) {
  for (int u = threadIdx.x; u < H * (K / 8); u += blockDim.x) {
    const int n = u & (H - 1), ch = u >> 7;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __ldg(src + (ch * 8 + e) * H + n);
    *reinterpret_cast<uint4*>(dst + (ch >> 3) * (H * 128) + n * 128 + (((ch & 7) ^ (n & 7)) << 4)) =
        make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
  }
}

// descriptor of k-step s (16 deep) of a staged weight
__device__ __forceinline__ uint64_t kdesc(const unsigned char* w, int s) {
  return sw128_desc(w + (s >> 2) * (H * 128)) + 2 * (s & 3);
}

// a bias in the layout the accumulator reads: thread quad member t's 32
// values (columns 8j + 2t, 8j + 2t + 1 for j = 0..15) contiguous
__device__ __forceinline__ void stage_bias(float* dst, const float* __restrict__ src) {
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const int j = c >> 3, t = (c & 7) >> 1, e = c & 1;
    dst[t * 32 + j * 2 + e] = src[c];
  }
}

// relu(acc + bias) rounded to the bf16 A pairs of the next product
__device__ __forceinline__ void relu_pack(const float (&acc)[64], const float* bias_t, uint32_t (&a)[32]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 bb = reinterpret_cast<const float4*>(bias_t)[k];  // columns of j = 2k and 2k + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * k + h;
      const float b0 = h ? bb.z : bb.x, b1 = h ? bb.w : bb.y;
      a[2 * j] = pack(fmaxf(acc[4 * j] + b0, 0.f), fmaxf(acc[4 * j + 1] + b1, 0.f));
      a[2 * j + 1] = pack(fmaxf(acc[4 * j + 2] + b0, 0.f), fmaxf(acc[4 * j + 3] + b1, 0.f));
    }
  }
}

// d (=|+)= A (64 x 128, the bf16 pairs a) @ the staged 128-deep weight w
__device__ __forceinline__ void chain128(float (&d)[64], const uint32_t (&a)[32], const unsigned char* w) {
#pragma unroll
  for (int s = 0; s < NK; ++s)
    wgmma_m64n128k16_rs(d, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3], kdesc(w, s), s);
}

}  // namespace r2

// Round 2 on register-A wgmma.  A warpgroup owns a unit of 64 consecutive
// rays of one row b; the tokens are sample-major, so for a fixed (v, s) the
// unit's 64 tokens are 64 consecutive rows of lc, one m64 tile.  Per unit
// it takes zw = bf16(ze) @ wra once (8 wgmma, A from ze in registers) and
// parks it in shared memory, thread-private, in the accumulator's layout.
// Per token tile:
//   1. x = lc @ wq and y = zw + lc @ wrb (two m64n128k16, A = the lc tile
//      in registers, loaded one tile ahead), one commit;
//   2. hq = bf16(relu(x + bq)), hr = bf16(relu(y + br)) in registers: the
//      accumulators become the A pairs of the next products;
//   3. ce = hq @ wq2 and qre = hr @ wr2 (8 + 8 m64n128k16, A from
//      registers), one commit;
//   4. the dot of (qre + br2) and (ce + bq2) over each row's 128 columns,
//      over a thread's 32 and then its lane quad; only the f32 logits leave.
// Every weight sits in shared memory once per persistent block, as
// 128-byte-swizzled K-major slabs (hopper.cuh's layout), rounded to bf16
// and staged by the threads (then fence.proxy.async for the tensor cores'
// reads).  ptxas gives the consumer 226 registers, so a block holds two
// warpgroups, and the 16 products of step 3 issue back to back (one
// WARPGROUP.DEPBAR for the group).  What holds it back: steps 2 and 4 run
// as long as the products again and more (a clock probe of each step,
// PERF.md), and two warpgroups do not hide them; turns at the tensor cores
// on named barriers, the biases in the accumulators and a bf16x2 relu did
// not help.
__global__ void __launch_bounds__(r2::kThreads, 1)
round2_kernel(const float* __restrict__ ze, const bf16* __restrict__ lc, const float* __restrict__ wq,
              const float* __restrict__ bq, const float* __restrict__ wq2, const float* __restrict__ bq2,
              const float* __restrict__ wra, const float* __restrict__ wrb, const float* __restrict__ br,
              const float* __restrict__ wr2, const float* __restrict__ br2, float* __restrict__ out,
              int B, int V, int S, int N) {
  using namespace r2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzled slabs: 1024-aligned
  unsigned char* s_wq2 = sm;
  unsigned char* s_wr2 = s_wq2 + kW128;
  unsigned char* s_wra = s_wr2 + kW128;
  unsigned char* s_wq = s_wra + kW128;
  unsigned char* s_wrb = s_wq + kW16;
  float* s_b = reinterpret_cast<float*>(s_wrb + kW16);  // bq, br, bq2, br2 in the quad layout
  float4* s_zw = reinterpret_cast<float4*>(s_b + 4 * H);
  stage_sw128(s_wq2, wq2, H);
  stage_sw128(s_wr2, wr2, H);
  stage_sw128(s_wra, wra, H);
  stage_sw128(s_wq, wq, L);
  stage_sw128(s_wrb, wrb, L);
  stage_bias(s_b, bq);
  stage_bias(s_b + H, br);
  stage_bias(s_b + 2 * H, bq2);
  stage_bias(s_b + 3 * H, br2);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the generic stores, before wgmma reads them
  __syncthreads();

  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127, warp = wt >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* b_q = s_b + t * 32;
  const float* b_r = s_b + H + t * 32;
  const float* b_q2 = s_b + 2 * H + t * 32;
  const float* b_r2 = s_b + 3 * H + t * 32;
  float4* zw = s_zw + wg * (kZw / 16) + wt;  // float4 i of this thread at zw[i * 128]
  const int groups = (N + kRays - 1) / kRays;
  const long long units = static_cast<long long>(B) * groups;
  const long long T = static_cast<long long>(S) * N;
  const int VS = V * S;

  for (long long unit = static_cast<long long>(blockIdx.x) * kWG + wg; unit < units;
       unit += static_cast<long long>(gridDim.x) * kWG) {
    const int b = static_cast<int>(unit / groups);
    const int na = static_cast<int>(unit - static_cast<long long>(b) * groups) * kRays + warp * 16 + g, nb = na + 8;
    const bool va = na < N, vb = nb < N;

    // zw = bf16(ze) @ wra for the unit's 64 rays
    {
      uint32_t zA[32];
#pragma unroll
      for (int s = 0; s < NK; ++s) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = s * 16 + half * 8 + 2 * t;
#pragma unroll
          for (int rs = 0; rs < 2; ++rs) {
            float2 z = make_float2(0.f, 0.f);
            if (rs ? vb : va)
              z = __ldg(reinterpret_cast<const float2*>(ze + (static_cast<long long>(b) * N + (rs ? nb : na)) * H + col));
            zA[4 * s + half * 2 + rs] = pack(z.x, z.y);
          }
        }
      }
      float acc[64];
      pin(zA);
      wgmma_fence();
      chain128(acc, zA, s_wra);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        zw[i * 128] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    }

    // the lc tile of token tile (v, s): rows na and nb of view row b*V + v, sample s
    auto lc_rows = [&](int v, int s, uint32_t (&a)[4]) {
      const long long base = (static_cast<long long>(b) * V + v) * T + static_cast<long long>(s) * N;
      load_lc(va ? lc + (base + na) * L : nullptr, vb ? lc + (base + nb) * L : nullptr, lane, a);
    };
    uint32_t lcA[4];
    lc_rows(0, 0, lcA);
    int v = 0, s = 0;
    for (int vs = 0; vs < VS; ++vs) {
      int vn = v, sn = s + 1;
      if (sn == S) { sn = 0; ++vn; }

      // 1. x = lc @ wq, y = zw + lc @ wrb
      float x[64], y[64];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 z = zw[i * 128];
        y[4 * i] = z.x;
        y[4 * i + 1] = z.y;
        y[4 * i + 2] = z.z;
        y[4 * i + 3] = z.w;
      }
      pin(lcA);
      pin(y);
      wgmma_fence();
      wgmma_m64n128k16_rs(x, lcA[0], lcA[1], lcA[2], lcA[3], kdesc(s_wq, 0), 0);
      wgmma_m64n128k16_rs(y, lcA[0], lcA[1], lcA[2], lcA[3], kdesc(s_wrb, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(x);
      pin(y);

      // 2. the hidden layers, rounded to bf16 A pairs
      uint32_t hq[32], hr[32];
      relu_pack(x, b_q, hq);
      relu_pack(y, b_r, hr);

      // 3. ce = hq @ wq2, qre = hr @ wr2
      float ce[64], qr[64];
      pin(hq);
      pin(hr);
      wgmma_fence();
      chain128(ce, hq, s_wq2);
      chain128(qr, hr, s_wr2);
      wgmma_commit();
      // the next tile's lc, loaded while the tensor cores run: issued
      // before the fence of step 1, a load's latency lands on that fence
      if (vs + 1 < VS) lc_rows(vn, sn, lcA);
      wgmma_wait<0>();
      pin(ce);
      pin(qr);
      pin(hq);
      pin(hr);

      // 4. the logits
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 c2 = reinterpret_cast<const float4*>(b_q2)[k], r2b = reinterpret_cast<const float4*>(b_r2)[k];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * k + h;
          const float cb0 = h ? c2.z : c2.x, cb1 = h ? c2.w : c2.y, rb0 = h ? r2b.z : r2b.x, rb1 = h ? r2b.w : r2b.y;
          s0 += (qr[4 * j] + rb0) * (ce[4 * j] + cb0) + (qr[4 * j + 1] + rb1) * (ce[4 * j + 1] + cb1);
          s1 += (qr[4 * j + 2] + rb0) * (ce[4 * j + 2] + cb0) + (qr[4 * j + 3] + rb1) * (ce[4 * j + 3] + cb1);
        }
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (t == 0) {
        const long long base = (static_cast<long long>(b) * V + v) * T + static_cast<long long>(s) * N;
        if (va) out[base + na] = s0 * kInvScale;
        if (vb) out[base + nb] = s1 * kInvScale;
      }
      v = vn;
      s = sn;
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

// ze (B, N, 128) f32; lc (B*V, S*N, 16) bf16 sample-major; weights in
// their (in, out) f32 layout, biases f32; out (B*V, S*N) f32
extern "C" int k7_round2_logits(const void* ze, const void* lc, const void* wq, const void* bq, const void* wq2,
                                const void* bq2, const void* wra, const void* wrb, const void* br, const void* wr2,
                                const void* br2, void* out, int B, int V, int S, int N, void* stream) {
  using namespace coponerf;
  if (static_cast<long long>(B) * V * S * N == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(round2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(r2::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long units = static_cast<long long>(B) * ((N + r2::kRays - 1) / r2::kRays);
  const long long need = (units + r2::kWG - 1) / r2::kWG;
  const int blocks = static_cast<int>(need < sms ? need : sms);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  round2_kernel<<<blocks, r2::kThreads, r2::kSmem, static_cast<cudaStream_t>(stream)>>>(
      f(ze), static_cast<const bf16*>(lc), f(wq), f(bq), f(wq2), f(bq2), f(wra), f(wrb), f(br), f(wr2), f(br2),
      static_cast<float*>(out), B, V, S, N);
  return static_cast<int>(cudaGetLastError());
}
