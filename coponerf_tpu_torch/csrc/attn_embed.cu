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
// against ~0.070 MFLOP a token: 2 * (128 * 128 + 16 * 128 + 128 * 128));
// round 2 is operations (~0.074 MFLOP a token, 2 * (2 * 16 * 128 + 2 * 128
// * 128), from 32 B of lc).
//
// Both run on Hopper's register-A wgmma: a warpgroup takes 64-token tiles,
// a hidden layer goes from one product's f32 accumulators into the next
// product's bf16 A pairs in registers, B (every weight) sits in shared
// memory once per persistent block as 128-byte-swizzled K-major slabs
// (rounded to bf16 and staged by the threads), and only the f32 logits
// leave the chip.

#include "attn_chain.cuh"
#include "hopper.cuh"

namespace coponerf {

using namespace chain;

// ------------------------------------------------- register-A wgmma chains --
namespace wg {

constexpr int kW128 = H * H * 2;  // a 128 x 128 bf16 weight: two 64-deep K slabs of 128 rows x 128 B
constexpr int kW16 = H * 128;     // a 16-deep weight in one slab (k 16.. unused)

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

// a bias in the layout the accumulator (and the A pairs) read: thread quad
// member t's 32 values (columns 8j + 2t, 8j + 2t + 1 for j = 0..15) contiguous
__device__ __forceinline__ void stage_bias(float* dst, const float* __restrict__ src) {
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const int j = c >> 3, t = (c & 7) >> 1, e = c & 1;
    dst[t * 32 + j * 2 + e] = src[c];
  }
}

// bf16(relu(lo)), bf16(relu(hi)) as a pair, in one instruction
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
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
      a[2 * j] = pack_relu(acc[4 * j] + b0, acc[4 * j + 1] + b1);
      a[2 * j + 1] = pack_relu(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
    }
  }
}

// d (=|+)= A (64 x 128, the bf16 pairs a) @ the staged 128-deep weight w
__device__ __forceinline__ void chain128(float (&d)[64], const uint32_t (&a)[32], const unsigned char* w) {
#pragma unroll
  for (int s = 0; s < NK; ++s)
    wgmma_m64n128k16_rs(d, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3], kdesc(w, s), s);
}

// four 8 x 8 bf16 matrices from shared memory (lanes 8i .. 8i + 7 give the
// row addresses of matrix i): r[i] holds row lane / 4, columns 2 (lane % 4)
// and 2 (lane % 4) + 1 of matrix i, the mma A-fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

}  // namespace wg

// ------------------------------------------------------------- round 1 --
namespace r1 {

constexpr int kWG = 3;                    // warpgroups a block, each on its own tiles
constexpr int kThreads = 128 * kWG;
constexpr int kRows = 64;                 // tokens a tile: the wgmma tile's M
constexpr int kBox = kRows * 128;         // one TMA box: 64 rows x 64 bf16 columns, 128-byte swizzled
constexpr int kKey = 2 * kBox;            // a tile of ka or kbs (128 columns)
constexpr int kLcRow = L * 2;             // bytes of an lc row
constexpr int kStage = 2 * kKey + kRows * kLcRow;  // ka, kbs, lc: 34 KB, one a warpgroup
constexpr size_t kSmem = 1024 + 2 * wg::kW128 + wg::kW16 + 4 * H * 4 + kWG * kStage + kWG * sizeof(uint64_t);

// tile's ka, kbs and lc into a stage, completing on bar
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map_ka, const CUtensorMap* map_kbs,
                                          const bf16* lc, uint64_t* bar, int tile, int M) {
  const int row0 = tile * kRows;
  const int rows = M - row0 < kRows ? M - row0 : kRows;
  mbar_expect_tx(bar, 2 * kKey + rows * kLcRow);  // a box past M still lands whole (zeros)
  tma_load_2d(dst, map_ka, bar, 0, row0);
  tma_load_2d(dst + kBox, map_ka, bar, 64, row0);
  tma_load_2d(dst + kKey, map_kbs, bar, 0, row0);
  tma_load_2d(dst + kKey + kBox, map_kbs, bar, 64, row0);
  bulk_load(dst + 2 * kKey, lc + static_cast<size_t>(row0) * L, rows * kLcRow, bar);
}

// a 64 x 64 accumulator set to a bias in the quad layout: both rows of a
// thread start from their columns' values
__device__ __forceinline__ void bias_acc(float (&d)[32], const float* bias_t) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 bb = reinterpret_cast<const float4*>(bias_t)[k];  // columns of j = 2k and 2k + 1
    d[8 * k] = d[8 * k + 2] = bb.x;
    d[8 * k + 1] = d[8 * k + 3] = bb.y;
    d[8 * k + 4] = d[8 * k + 6] = bb.z;
    d[8 * k + 5] = d[8 * k + 7] = bb.w;
  }
}

// d += A (64 x 128, the bf16 pairs a) @ columns 64h .. 64h + 63 of the
// staged 128-deep weight w
__device__ __forceinline__ void chain64(float (&d)[32], const uint32_t (&a)[32], const unsigned char* w, int h) {
#pragma unroll
  for (int s = 0; s < NK; ++s)
    wgmma_m64n64k16_rs(d, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3], wg::kdesc(w + h * 64 * 128, s), 1);
}

}  // namespace r1

// Round 1 on register-A wgmma, fed by TMA.  A block holds three
// warpgroups; each walks its own 64-token tiles through a stage of its own
// in shared memory: ka's and kbs's tiles arrive as two 64 x 64 TMA boxes
// each (128-byte swizzle; rows past M read as zeros), lc's as one bulk copy
// of its valid rows, all on one mbarrier.  As soon as all 128 threads of
// the warpgroup have read the stage (a named barrier), one of them issues
// the load of its next tile into it, which lands while the tensor cores
// run the chains.  The second layer's accumulators start from their
// biases (in the quad layout), so the dot is one FFMA a column, and relu
// and the bf16 rounding of a hidden pair are one cvt.rn.relu.bf16x2:
// less for the threads to do between the products.  Per tile:
//   1. x = lc @ wq (one m64n128k16, A = the lc tile by ldmatrix),
//      committed;
//   2. while it runs: ka and kbs by ldmatrix (the swizzle keeps the eight
//      rows of each 8 x 8 matrix in distinct banks), + fkb, relu, rounded
//      to the key product's bf16 A pairs: the mma A-fragment layout that
//      ldmatrix gives is the register-A wgmma's;
//   3. hq = bf16(relu(x + bq)) in registers;
//   4. per 64-column half: ce = bq2 + hq @ wq2 and kv = bk2 + kA @ wk2
//      (8 + 8 m64n64k16), one commit, and the half's share of the dot;
//   5. the dot over the lane quad; only the f32 logits leave.
// Halves keep the accumulators at 64 registers, so three warpgroups fit
// (ptxas: 168 registers, a few words spilled, the products not serialized)
// and hide one another's epilogues; two warpgroups of n128 chains ran
// slower.  What holds it back: the threads' work between the products,
// not the key stream (PERF.md).  Rows index in 32 bits (M < 2^31).
__global__ void __launch_bounds__(r1::kThreads, 1)
round1_kernel(const __grid_constant__ CUtensorMap map_ka, const __grid_constant__ CUtensorMap map_kbs,
              const bf16* __restrict__ lc, const float* __restrict__ fkb, const float* __restrict__ wk2,
              const float* __restrict__ bk2, const float* __restrict__ wq, const float* __restrict__ bq,
              const float* __restrict__ wq2, const float* __restrict__ bq2, float* __restrict__ out, int M) {
  using namespace r1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzled tiles: 1024-aligned
  unsigned char* s_wk2 = sm;
  unsigned char* s_wq2 = s_wk2 + wg::kW128;
  unsigned char* s_wq = s_wq2 + wg::kW128;
  float* s_b = reinterpret_cast<float*>(s_wq + wg::kW16);  // fkb, bk2, bq, bq2 in the quad layout
  unsigned char* stages = reinterpret_cast<unsigned char*>(s_b + 4 * H);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kWG * kStage);

  const int w = threadIdx.x >> 7, wt = threadIdx.x & 127, warp = wt >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  unsigned char* stg = stages + w * kStage;
  uint64_t* bar = full + w;
  const int tiles = (M + kRows - 1) / kRows;
  const int first = blockIdx.x * kWG + w, step = gridDim.x * kWG;

  if (wt == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wt == 0 && first < tiles) load_tile(stg, &map_ka, &map_kbs, lc, bar, first, M);  // under the staging
  wg::stage_sw128(s_wk2, wk2, H);
  wg::stage_sw128(s_wq2, wq2, H);
  wg::stage_sw128(s_wq, wq, L);
  wg::stage_bias(s_b, fkb);
  wg::stage_bias(s_b + H, bk2);
  wg::stage_bias(s_b + 2 * H, bq);
  wg::stage_bias(s_b + 3 * H, bq2);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the generic stores, before wgmma reads them
  __syncthreads();

  const float* b_fk = s_b + t * 32;
  const float* b_k2 = s_b + H + t * 32;
  const float* b_q = s_b + 2 * H + t * 32;
  const float* b_q2 = s_b + 3 * H + t * 32;
  // this lane's ldmatrix row: matrix i = lane / 8 covers rows 8 (i & 1) ..
  // of the warp's 16 and the 8 columns 8 (i >> 1) .. of each 16-deep k-step
  const int mi = lane >> 3;
  const int lrow = warp * 16 + ((mi & 1) << 3) + (lane & 7);

  uint32_t parity = 0;
  for (int tile = first; tile < tiles; tile += step, parity ^= 1) {
    mbar_wait(bar, parity);

    // 1. x = lc @ wq
    uint32_t lcA[4];
    wg::ldsm_x4(lcA, stg + 2 * kKey + lrow * kLcRow + (mi >> 1) * 16);
    float x[64];
    pin(lcA);
    wgmma_fence();
    wgmma_m64n128k16_rs(x, lcA[0], lcA[1], lcA[2], lcA[3], wg::kdesc(s_wq, 0), 0);
    wgmma_commit();

    // 2. relu(ka + kbs + fkb) as the key product's A pairs
    uint32_t kA[32];
#pragma unroll
    for (int s = 0; s < NK; ++s) {
      const int chunk = 2 * s + (mi >> 1);  // 16-byte chunk of the 128 columns
      const int off = (chunk >> 3) * kBox + lrow * 128 + (((chunk & 7) ^ (lrow & 7)) << 4);
      uint32_t a[4], b[4];
      wg::ldsm_x4(a, stg + off);
      wg::ldsm_x4(b, stg + kKey + off);
      const float4 bb = reinterpret_cast<const float4*>(b_fk)[s];  // columns 16s + 2t (+1), 16s + 8 + 2t (+1)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 xa = unpack(a[r]), xb = unpack(b[r]);
        kA[4 * s + r] = wg::pack_relu(xa.x + xb.x + (r < 2 ? bb.x : bb.z), xa.y + xb.y + (r < 2 ? bb.y : bb.w));
      }
    }
    // every thread has read the stage: load the next tile into it
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(128) : "memory");
    if (wt == 0 && tile + step < tiles) load_tile(stg, &map_ka, &map_kbs, lc, bar, tile + step, M);

    // 3. the query's hidden layer
    wgmma_wait<0>();
    pin(x);
    pin(lcA);
    uint32_t hq[32];
    wg::relu_pack(x, b_q, hq);

    // 4. ce = bq2 + hq @ wq2 and kv = bk2 + kA @ wk2 a 64-column half at a
    // time, and the half's share of the dot
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ce[32], kv[32];
      bias_acc(ce, b_q2 + 16 * h);
      bias_acc(kv, b_k2 + 16 * h);
      pin(ce);
      pin(kv);
      pin(hq);
      pin(kA);
      wgmma_fence();
      chain64(ce, hq, s_wq2, h);
      chain64(kv, kA, s_wk2, h);
      wgmma_commit();
      wgmma_wait<0>();
      pin(ce);
      pin(kv);
      pin(hq);
      pin(kA);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s0 += kv[4 * j] * ce[4 * j] + kv[4 * j + 1] * ce[4 * j + 1];
        s1 += kv[4 * j + 2] * ce[4 * j + 2] + kv[4 * j + 3] * ce[4 * j + 3];
      }
    }

    // 5. the logits
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (t == 0) {
      const int ra = tile * kRows + warp * 16 + (lane >> 2), rb = ra + 8;
      if (ra < M) out[ra] = s0 * kInvScale;
      if (rb < M) out[rb] = s1 * kInvScale;
    }
  }
}

// ------------------------------------------------------------- round 2 --
namespace r2 {

constexpr int kWG = 2;                      // warpgroups a block, each on its own 64-ray units
constexpr int kThreads = 128 * kWG;
constexpr int kRays = 64;                   // rays a unit: the wgmma tile's M
constexpr int kZw = kRays * H * 4;          // a warpgroup's zw, f32
constexpr size_t kSmem = 1024 + 3 * wg::kW128 + 2 * wg::kW16 + 4 * H * 4 + kWG * kZw;

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
// ptxas gives the consumer 226 registers, so a block holds two
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
  unsigned char* s_wr2 = s_wq2 + wg::kW128;
  unsigned char* s_wra = s_wr2 + wg::kW128;
  unsigned char* s_wq = s_wra + wg::kW128;
  unsigned char* s_wrb = s_wq + wg::kW16;
  float* s_b = reinterpret_cast<float*>(s_wrb + wg::kW16);  // bq, br, bq2, br2 in the quad layout
  float4* s_zw = reinterpret_cast<float4*>(s_b + 4 * H);
  wg::stage_sw128(s_wq2, wq2, H);
  wg::stage_sw128(s_wr2, wr2, H);
  wg::stage_sw128(s_wra, wra, H);
  wg::stage_sw128(s_wq, wq, L);
  wg::stage_sw128(s_wrb, wrb, L);
  wg::stage_bias(s_b, bq);
  wg::stage_bias(s_b + H, br);
  wg::stage_bias(s_b + 2 * H, bq2);
  wg::stage_bias(s_b + 3 * H, br2);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the generic stores, before wgmma reads them
  __syncthreads();

  const int w = threadIdx.x >> 7, wt = threadIdx.x & 127, warp = wt >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* b_q = s_b + t * 32;
  const float* b_r = s_b + H + t * 32;
  const float* b_q2 = s_b + 2 * H + t * 32;
  const float* b_r2 = s_b + 3 * H + t * 32;
  float4* zw = s_zw + w * (kZw / 16) + wt;  // float4 i of this thread at zw[i * 128]
  const int groups = (N + kRays - 1) / kRays;
  const long long units = static_cast<long long>(B) * groups;
  const long long T = static_cast<long long>(S) * N;
  const int VS = V * S;

  for (long long unit = static_cast<long long>(blockIdx.x) * kWG + w; unit < units;
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
      wg::chain128(acc, zA, s_wra);
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
      wgmma_m64n128k16_rs(x, lcA[0], lcA[1], lcA[2], lcA[3], wg::kdesc(s_wq, 0), 0);
      wgmma_m64n128k16_rs(y, lcA[0], lcA[1], lcA[2], lcA[3], wg::kdesc(s_wrb, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(x);
      pin(y);

      // 2. the hidden layers, rounded to bf16 A pairs
      uint32_t hq[32], hr[32];
      wg::relu_pack(x, b_q, hq);
      wg::relu_pack(y, b_r, hr);

      // 3. ce = hq @ wq2, qre = hr @ wr2
      float ce[64], qr[64];
      pin(hq);
      pin(hr);
      wgmma_fence();
      wg::chain128(ce, hq, s_wq2);
      wg::chain128(qr, hr, s_wr2);
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

static int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace coponerf

// ka, kbs (M, 128) bf16, 16-byte aligned; lc (M, 16) bf16, 16-byte
// aligned; weights in their (in, out) f32 layout, biases f32; out (M,) f32;
// M < 2^31
extern "C" int k7_round1_logits(const void* ka, const void* kbs, const void* lc, const void* fkb,
                                const void* wk2, const void* bk2, const void* wq, const void* bq,
                                const void* wq2, const void* bq2, void* out, long long M, void* stream) {
  using namespace coponerf;
  if (M == 0) return 0;
  if (M < 0 || M >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  if (!hopper::bf16_map(&maps[0], ka, H, static_cast<uint64_t>(M), r1::kRows) ||
      !hopper::bf16_map(&maps[1], kbs, H, static_cast<uint64_t>(M), r1::kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(round1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(r1::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int Mi = static_cast<int>(M);
  const int tiles = (Mi + r1::kRows - 1) / r1::kRows;
  const int need = (tiles + r1::kWG - 1) / r1::kWG;
  const int sms = sm_count();
  const int blocks = need < sms ? need : sms;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  round1_kernel<<<blocks, r1::kThreads, r1::kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], static_cast<const bf16*>(lc), f(fkb), f(wk2), f(bk2), f(wq), f(bq), f(wq2), f(bq2),
      static_cast<float*>(out), Mi);
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
  const long long units = static_cast<long long>(B) * ((N + r2::kRays - 1) / r2::kRays);
  const long long need = (units + r2::kWG - 1) / r2::kWG;
  const int sms = sm_count();
  const int blocks = static_cast<int>(need < sms ? need : sms);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  round2_kernel<<<blocks, r2::kThreads, r2::kSmem, static_cast<cudaStream_t>(stream)>>>(
      f(ze), static_cast<const bf16*>(lc), f(wq), f(bq), f(wq2), f(bq2), f(wra), f(wrb), f(br), f(wr2), f(br2),
      static_cast<float*>(out), B, V, S, N);
  return static_cast<int>(cudaGetLastError());
}
