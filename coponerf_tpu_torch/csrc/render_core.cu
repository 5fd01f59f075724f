// K6: the post-sampling render core, one ray at a time per block.
//
// Replaces coponerf_tpu/ops/pallas/experimental/render_core.py:render_core
// (_kernel).  For one ray (b, n) with V views x S samples in each of the two
// sample sets (p: own view, s: the other view, rows view-flipped):
//   pre_x = relu([lev0 | lev1 | lev2 | levc] @ W1 + tanh(pt / 5) @ W1t + b1)   (832, bf16)
//   kpre  = pre_p @ fka + flip(pre_s) @ fkb + fk_bias
//   dot1  = sum((relu(kpre) @ wk2 + bk2) * ce) / 11.31,  ce = relu(lc @ wq + bq) @ wq2 + bq2
//   w1    = softmax over the V * S tokens of dot1              -> at_wt
//   z1    = bf16(sum w1 pre_p) @ flva + bf16(sum w1 flip(pre_s)) @ flvb + flv_bias
//   ze    = bf16(z1) @ wenc + benc
//   dot2  = sum((relu(ze @ wra + lc @ wrb + brr) @ wr2 + br2) * ce) / 11.31
//   z_sum = bf16(sum w2 pre_p) @ flva + bf16(sum w2 flip(pre_s)) @ flvb + flv_bias + V * z1
// bf16 operands with f32 sums throughout, as the TPU kernel.
//
// What bounds it on the H100: operations.  W1 and the key folds are ~0.41
// GFLOP a ray at S 64, V 2 against ~0.43 MB of samples; a 32768-ray chunk
// needs ~14 TFLOP, 14.2 ms at the bf16 peak.  No 832-wide activation
// reaches the output.
//
// Design: W1 runs once a ray, on K2's pipeline (hopper.cuh).  One
// persistent block per SM walks the rays; one producer thread keeps a ring
// of 4 shared-memory stages in flight with TMA and mbarriers; two consumer
// warpgroups (setmaxnreg 240 / 24) run wgmma m64n208k16 on 128-row tiles.
// A tile is 128 tokens of one sample set of one ray (one tile a set at
// V * S <= 128).  A ray's tokens are strided in the (B*V, S*N, C) level
// tensors, so each level is read through a 3-D map {C, N, B*V*S} whose box
// {64, 1, 128} at (k0, n, b*V*S + 128 * tile) lands token v*S + s in row
// v*S + s of the swizzled tile.  Rows past V * S (the next ray's tokens,
// or TMA's zero fill at the end) are computed and then weigh 0.  The
// epilogue adds the tanh products and the bias, applies the relu, rounds
// to bf16 in registers and stores the tile with plain stores into the
// block's scratch slot in device memory, which is read back at once; the
// rounded pairs are the register-A operand of the key head (fka for p
// tiles, fkb for s tiles), whose f32 partials go to the slot too.
//
// Phase B, the per-ray tail, runs on the 256 consumer threads alone, on a
// named barrier.  Its large reads go through the same ring: once the
// consumers have fenced their slot stores (fence.proxy.async) and arrived
// on slot_ready, the producer queues, for each attention round, the slot's
// pre-activation rows (16 a slice) and flva, flvb (32 rows a slice) as
// bulk copies, so TMA keeps up to 4 slices of them in flight, also while
// the consumers run the chains: 8 warps reading them from L2 themselves
// kept too few loads in flight, and those reads took most of the tail.
// The tail: kpre from the two key partials (p token (v, s) pairs with s
// row (V-1-v)*S + s); the round-1 chain, a 16-token tile a warp
// (attn_chain.cuh; its biases and 16-deep weights in shared memory, the
// 128 x 128 ones from L2); the exact softmax and at_wt; the weighted sums;
// the value product for z1; ze and ze @ wra split over all 256 threads;
// the round-2 chain, its softmax, the round-2 sums and the value product
// for z_sum + V * z1.
// What holds it back (a clock probe of each step on an H100 SXM at 700 W,
// PERF.md): the tail leaves the tensor cores idle for more than half of a
// chunk's ~80 ms; within it the two chains (8 warps, one tile each, their
// 128 x 128 weights from L2) and the per-ray value products (flva and
// flvb, 1.4 MB, streamed twice a ray, near the L2's rate when every SM
// streams them).

#include <math.h>

#include "attn_chain.cuh"
#include "hopper.cuh"

namespace coponerf {
namespace rc {

using chain::bf16;

constexpr int C0 = 256, CC = 64;    // level widths: three UFC levels, conv_map
constexpr int KX = 3 * C0 + CC;     // 832 sampled channels
constexpr int NO = 832;             // W1 output width
constexpr int NZ = 416;             // value width
constexpr int HK = 128;             // key width
constexpr int BM = 128;             // tokens a tile: two consumer warpgroups of 64
constexpr int BN = 208;             // output columns a chunk
constexpr int BK = kBoxK;           // K depth of a ring slice
constexpr int STAGES = 4;           // ring stages: the tail's vectors leave no room for a fifth
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int F_BYTES = HK * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int F_STEPS = (BN + BK - 1) / BK;  // fk slices a chunk (the last one partly used)
constexpr int CHUNKS = NO / BN;
constexpr int KBP = C0 / BK;                 // K slices of each 256-wide level
constexpr int KB = KX / BK;                  // K slices a chunk
constexpr int CONSUMERS = 256;               // warps 0-7; the producer: warps 8-11
constexpr int THREADS = CONSUMERS + 128;
constexpr int kBar = 1;                      // the consumers' named barrier
constexpr int MAX_TOKENS = 1024;             // V * S a ray: its logit rows live in shared memory
constexpr int WS_ROWS = 16;                  // slot rows a ring slice of the weighted sums
constexpr int V_ROWS = 32;                   // flva / flvb rows a ring slice of the value products
constexpr int WS_BYTES = WS_ROWS * NO * 2;
constexpr int V_BYTES = V_ROWS * NZ * 2;
static_assert(WS_BYTES <= STAGE_BYTES && V_BYTES <= STAGE_BYTES && NO % V_ROWS == 0, "tail slices fit a stage");

// one block's scratch slot: the rounded pre-activations of both sets
// (2 x vsp x 832 bf16), then their key partials (2 x vsp x 128 f32); rows
// of the s set in its tensor (view-flipped) order
__host__ __device__ inline size_t slot_bytes(int vsp) {
  return static_cast<size_t>(vsp) * (2 * NO * 2 + 2 * HK * 4);
}

// shared memory: the ring (1024-aligned), W1's tanh rows and bias, the
// barriers, then phase B's vectors, the two logit rows, the s set's
// weights in slot order, the chain biases and the two 16-deep chain weights
__host__ __device__ inline size_t smem_bytes(int vsp) {
  return 1024 + static_cast<size_t>(STAGES) * STAGE_BYTES + 4ull * NO * 4 + (2ull * STAGES + 2) * 8 +
         (2ull * NO + NZ + 2ull * HK + 16ull * HK + 6ull * HK) * 4 + 3ull * vsp * 4 + 2ull * HK * chain::LDL * 2;
}

struct Maps {
  CUtensorMap lev[2][4];  // each set's levels as {C, N, B*V*S}, boxes 64 x 1 x 128
  CUtensorMap w;          // W1's first 832 rows transposed (832 x 832), boxes 64 x 208
  CUtensorMap fk[2];      // fka, fkb transposed (128 x 832), boxes 64 x 128
};

struct Params {
  const bf16* pt[2];   // (B*V, S*N, 3) of each set
  const bf16* lc;      // (B*V, S*N, 16)
  const float* wt3;    // W1's three tanh rows (3, 832)
  const float* w1b;
  const float* fkbias;
  const bf16* wk2t;    // transposed (out x in)
  const float* bk2;
  const bf16* wqt;
  const float* bq;
  const bf16* wq2t;
  const float* bq2;
  const bf16* wra;     // (128, 128)
  const bf16* wrbt;
  const float* brr;
  const bf16* wr2t;
  const float* br2;
  const bf16* wenc;    // (416, 128)
  const float* benc;
  const bf16* flva;    // (832, 416)
  const bf16* flvb;
  const float* flvbias;
  unsigned char* scratch;  // gridDim.x slots
  float* zsum;         // (B, N, 416)
  float* atwt;         // (B, N, V*S)
  int B, V, S, N;
};

__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBar), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the ray's softmax over its VS logits, by one warp, in place (and into out)
__device__ __forceinline__ void softmax(float* lg, int VS, float* out, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < VS; j += 32) m = fmaxf(m, lg[j]);
  m = warp_max(m);
  float z = 0.f;
  for (int j = lane; j < VS; j += 32) z += expf(lg[j] - m);
  z = warp_sum(z);
  for (int j = lane; j < VS; j += 32) {
    const float w = expf(lg[j] - m) / z;
    lg[j] = w;
    if (out) out[j] = w;
  }
}

// partials of x (K, bf16-rounded) @ w (K x 128, bf16) into red (16 x 128):
// thread (kq, u) 8 columns u*8.. over a sixteenth of K, 16-byte loads
__device__ __forceinline__ void small_product(const float* x, int K, const bf16* w, float* red) {
  const int tid = threadIdx.x, kq = tid >> 4, u = tid & 15;
  const int k0 = kq * K / 16, k1 = (kq + 1) * K / 16;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(w + static_cast<long long>(k) * HK + u * 8));
    const float xk = bfr(x[k]);
    const uint32_t h[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = chain::unpack(h[e]);
      acc[2 * e] = fmaf(xk, f.x, acc[2 * e]);
      acc[2 * e + 1] = fmaf(xk, f.y, acc[2 * e + 1]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[kq * HK + u * 8 + e] = acc[e];
}

__device__ __forceinline__ float sum16(const float* red, int c) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) a += red[i * HK + c];
  return a;
}

// a 16-token tile's logits over all 16 output tiles (attn_chain.cuh), the
// 128 x 128 weights from L2.  Not inlined: ptxas then gives the chain
// registers of its own instead of spilling it beside the rest of the
// consumer loop
__device__ __noinline__ void dots(const uint32_t (&pA)[chain::NK][4], const bf16* wp, const float* bp,
                                  const uint32_t (&qA)[chain::NK][4], const bf16* wq, const float* bq, int lane,
                                  float& s0, float& s1) {
  chain::dot_rows<chain::NJ>(pA, wp, bp, qA, wq, bq, chain::H, 0, lane, s0, s1);
}

// relu(kp + ks + bias) of two adjacent key columns, rounded to a bf16 pair
__device__ __forceinline__ uint32_t key_pair(const float* kp, const float* ks, const float* bias, int col) {
  const float2 a = __ldcg(reinterpret_cast<const float2*>(kp + col));
  const float2 c = __ldcg(reinterpret_cast<const float2*>(ks + col));
  return chain::pack(fmaxf((a.x + c.x) + bias[col], 0.f), fmaxf((a.y + c.y) + bias[col + 1], 0.f));
}

__global__ void __launch_bounds__(THREADS, 1) render_core_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled stages need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* wt_s = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* bias_s = wt_s + 3 * NO;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + NO);
  uint64_t* empty = full + STAGES;
  uint64_t* slot_ready = empty + STAGES;  // the ray's pre-activations are in the slot
  float* ua = reinterpret_cast<float*>(slot_ready + 2);  // 16-byte aligned from here on
  float* ub = ua + NO;
  float* z1 = ub + NO;
  float* ze = z1 + NZ;
  float* zw = ze + HK;
  float* red = zw + HK;
  float* lg1 = red + 16 * HK;
  const int V = p.V, S = p.S, N = p.N, VS = V * S;
  const int tiles = (VS + BM - 1) / BM;
  const int vsp = tiles * BM;
  const int nws = (VS + WS_ROWS - 1) / WS_ROWS;  // ring slices of one set's pre-activations
  float* lg2 = lg1 + vsp;
  float* wfl = lg2 + vsp;  // the softmax weight of each slot row of the s set
  float* cb = wfl + vsp;  // the chain biases: bq, bq2, bk2, brr, br2, fk_bias
  bf16* wq = reinterpret_cast<bf16*>(cb + 6 * HK);  // the 16-deep chain weights, transposed
  bf16* wrb = wq + HK * chain::LDL;

  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * NO; i += THREADS) wt_s[i] = p.wt3[i];
  for (int i = tid; i < NO; i += THREADS) bias_s[i] = p.w1b[i];
  for (int i = VS + tid; i < vsp; i += THREADS) lg1[i] = lg2[i] = wfl[i] = 0.f;  // rows past V*S weigh 0
  for (int i = tid; i < HK; i += THREADS) {
    cb[i] = p.bq[i];
    cb[HK + i] = p.bq2[i];
    cb[2 * HK + i] = p.bk2[i];
    cb[3 * HK + i] = p.brr[i];
    cb[4 * HK + i] = p.br2[i];
    cb[5 * HK + i] = p.fkbias[i];
  }
  for (int u = tid; u < HK * 2; u += THREADS) {
    const int r = u >> 1, c = (u & 1) * 8;
    *reinterpret_cast<uint4*>(wq + r * chain::LDL + c) = *reinterpret_cast<const uint4*>(p.wqt + r * chain::L + c);
    *reinterpret_cast<uint4*>(wrb + r * chain::LDL + c) = *reinterpret_cast<const uint4*>(p.wrbt + r * chain::L + c);
  }
  const float *bq = cb, *bq2 = cb + HK, *bk2 = cb + 2 * HK, *brr = cb + 3 * HK, *br2 = cb + 4 * HK, *fkb = cb + 5 * HK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_init(slot_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long rays = static_cast<long long>(p.B) * N;
  const bf16* pre = reinterpret_cast<const bf16*>(p.scratch + static_cast<size_t>(blockIdx.x) * slot_bytes(vsp));
  if (tid >= CONSUMERS) {
    // producer: one thread issues every load into the ring, in the order
    // the consumers take them: per ray the W1 slices of its tiles, then
    // for each attention round the slot's pre-activation rows (the
    // weighted sums) and flva, flvb (the value product)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0, sphase = 0;
      auto bulk = [&](const void* src, uint32_t bytes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], bytes);
        bulk_load(smem + stage * STAGE_BYTES, src, bytes, &full[stage]);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      };
      for (long long ray = blockIdx.x; ray < rays; ray += gridDim.x) {
        const int b = static_cast<int>(ray / N), n = static_cast<int>(ray - static_cast<long long>(b) * N);
        for (int set = 0; set < 2; ++set) {
          for (int t = 0; t < tiles; ++t) {
            const int row0 = b * VS + t * BM;
            for (int c = 0; c < CHUNKS; ++c) {
              for (int kb = 0; kb < KB; ++kb) {
                mbar_wait(&empty[stage], phase ^ 1);
                unsigned char* st = smem + stage * STAGE_BYTES;
                mbar_expect_tx(&full[stage], STAGE_BYTES);
                const int part = kb < 3 * KBP ? kb / KBP : 3;
                tma_load_3d(st, &maps.lev[set][part], &full[stage], (kb - part * KBP) * BK, n, row0);
                tma_load_2d(st + A_BYTES, &maps.w, &full[stage], kb * BK, c * BN);
                if (++stage == STAGES) { stage = 0; phase ^= 1; }
              }
              for (int f = 0; f < F_STEPS; ++f) {
                mbar_wait(&empty[stage], phase ^ 1);
                mbar_expect_tx(&full[stage], F_BYTES);
                tma_load_2d(smem + stage * STAGE_BYTES + A_BYTES, &maps.fk[set], &full[stage], c * BN + f * BK, 0);
                if (++stage == STAGES) { stage = 0; phase ^= 1; }
              }
            }
          }
        }
        mbar_wait(slot_ready, sphase);  // the consumers' slot stores are done and fenced
        sphase ^= 1;
        for (int round = 0; round < 2; ++round) {
          for (int set = 0; set < 2; ++set)
            for (int i = 0; i < nws; ++i) bulk(pre + (static_cast<size_t>(set) * vsp + i * WS_ROWS) * NO, WS_BYTES);
          for (int i = 0; i < NO / V_ROWS; ++i) bulk(p.flva + static_cast<size_t>(i) * V_ROWS * NZ, V_BYTES);
          for (int i = 0; i < NO / V_ROWS; ++i) bulk(p.flvb + static_cast<size_t>(i) * V_ROWS * NZ, V_BYTES);
        }
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, cw = tid >> 5;
  const int r_in = wg * 64 + warp * 16 + (lane >> 2);  // this thread's tile rows: r_in and r_in + 8
  const int q2 = (lane & 3) * 2;                       // and columns q2, q2 + 1 of each 8-column group
  const int g = lane >> 2, t4 = lane & 3;
  bf16* slot = const_cast<bf16*>(pre);
  float* keys = reinterpret_cast<float*>(slot + 2 * static_cast<size_t>(vsp) * NO);
  int stage = 0;
  uint32_t phase = 0;

  // the tail's ring slices: wait for the next one; hand it back once every
  // lane of the warp has read it
  auto next_slice = [&]() -> const unsigned char* {
    mbar_wait(&full[stage], phase);
    return smem + stage * STAGE_BYTES;
  };
  auto free_slice = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  };
  // ua[c] = bf16(sum_t w[t] pre_p[t, c]), ub[c] = bf16(sum_t w[t] pre_s[flip(t), c]):
  // the slot's rows stream through the ring, 4 columns a thread
  auto weighted_sums = [&](const float* w) {
    for (int set = 0; set < 2; ++set) {
      const float* ws = set ? wfl : w;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < nws; ++i) {
        const bf16* rows = reinterpret_cast<const bf16*>(next_slice());
        if (tid < NO / 4) {
#pragma unroll 4
          for (int r = 0; r < WS_ROWS; ++r) {
            const float x = ws[i * WS_ROWS + r];
            const uint2 q = *reinterpret_cast<const uint2*>(rows + r * NO + 4 * tid);
            const float2 f0 = chain::unpack(q.x), f1 = chain::unpack(q.y);
            acc[0] = fmaf(x, f0.x, acc[0]);
            acc[1] = fmaf(x, f0.y, acc[1]);
            acc[2] = fmaf(x, f1.x, acc[2]);
            acc[3] = fmaf(x, f1.y, acc[3]);
          }
        }
        free_slice();
      }
      if (tid < NO / 4) {
        float* out = (set ? ub : ua) + 4 * tid;
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = bfr(acc[e]);
      }
    }
  };
  // z[c] = sum_k ua[k] flva[k, c] + sum_k ub[k] flvb[k, c] + bias[c] (+ add_scale * add[c])
  // (ua, ub hold bf16 values): flva and flvb stream through the ring, two
  // adjacent columns a thread
  auto values = [&](float* z, const float* add, float add_scale) {
    const int c = 2 * tid;
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    for (int half = 0; half < 2; ++half) {
      const float* x = half ? ub : ua;
      float s0 = 0.f, s1 = 0.f;
      for (int i = 0; i < NO / V_ROWS; ++i) {
        const bf16* rows = reinterpret_cast<const bf16*>(next_slice());
        if (tid < NZ / 2) {
#pragma unroll 8
          for (int r = 0; r < V_ROWS; ++r) {
            const float xk = x[i * V_ROWS + r];
            const float2 f = chain::unpack(*reinterpret_cast<const uint32_t*>(rows + r * NZ + c));
            s0 = fmaf(xk, f.x, s0);
            s1 = fmaf(xk, f.y, s1);
          }
        }
        free_slice();
      }
      if (half) {
        b0 = s0;
        b1 = s1;
      } else {
        a0 = s0;
        a1 = s1;
      }
    }
    if (tid < NZ / 2) {
      float z0 = (a0 + b0) + p.flvbias[c], zz1 = (a1 + b1) + p.flvbias[c + 1];
      if (add) {
        z0 += add_scale * add[c];
        zz1 += add_scale * add[c + 1];
      }
      z[c] = z0;
      z[c + 1] = zz1;
    }
  };
  // the s set's slot row i = (V-1-v)*S + s weighs as token v*S + s
  auto flip_weights = [&](const float* w) {
    for (int i = tid; i < VS; i += CONSUMERS) wfl[i] = w[(V - 1 - i / S) * S + i % S];
  };

  for (long long ray = blockIdx.x; ray < rays; ray += gridDim.x) {
    const int b = static_cast<int>(ray / N), n = static_cast<int>(ray - static_cast<long long>(b) * N);
    auto token = [&](int t) { return (static_cast<long long>(b) * VS + t) * N + n; };  // t = v*S + s

    // ---------------- phase A: W1 and the key heads of every tile, into the slot
    for (int set = 0; set < 2; ++set) {
      for (int t = 0; t < tiles; ++t) {
        const int ia = t * BM + r_in, ib = ia + 8;  // slot rows
        float ta[3], tb[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          ta[j] = ia < VS ? tanhf(__fdiv_rn(__bfloat162float(p.pt[set][token(ia) * 3 + j]), 5.0f)) : 0.f;
          tb[j] = ib < VS ? tanhf(__fdiv_rn(__bfloat162float(p.pt[set][token(ib) * 3 + j]), 5.0f)) : 0.f;
        }
        bf16* oa = slot + (static_cast<size_t>(set) * vsp + ia) * NO;
        bf16* ob = oa + 8 * NO;
        float kacc[64];
        for (int c = 0; c < CHUNKS; ++c) {
          // the chunk's product: 13 K slices, one wgmma group in flight
          float acc[BN / 2];
          int prev = 0;
          for (int kb = 0; kb < KB; ++kb) {
            mbar_wait(&full[stage], phase);
            const unsigned char* st = smem + stage * STAGE_BYTES;
            const uint64_t da = sw128_desc(st + wg * 64 * 128), db = sw128_desc(st + A_BYTES);
            pin(acc);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < BK / 16; ++k) wgmma_m64n208k16_ss(acc, da + 2 * k, db + 2 * k, kb | k);
            wgmma_commit();
            pin(acc);
            if (kb > 0) {
              wgmma_wait<1>();
              pin(acc);
              if (lane == 0) mbar_arrive(&empty[prev]);
            }
            prev = stage;
            if (++stage == STAGES) { stage = 0; phase ^= 1; }
          }
          wgmma_wait<0>();
          pin(acc);
          if (lane == 0) mbar_arrive(&empty[prev]);

          // epilogue in registers: tanh products, bias, relu, round; store the
          // chunk into the slot and keep the rounded pairs for the key head
          uint32_t packed[BN / 4];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = c * BN + 8 * j + q2;
            const float2 w0 = *reinterpret_cast<const float2*>(wt_s + col);
            const float2 w1 = *reinterpret_cast<const float2*>(wt_s + NO + col);
            const float2 w2 = *reinterpret_cast<const float2*>(wt_s + 2 * NO + col);
            const float2 bb = *reinterpret_cast<const float2*>(bias_s + col);
            packed[2 * j] = pack_bf16(epilogue(acc[4 * j], ta, w0.x, w1.x, w2.x, bb.x),
                                      epilogue(acc[4 * j + 1], ta, w0.y, w1.y, w2.y, bb.y));
            packed[2 * j + 1] = pack_bf16(epilogue(acc[4 * j + 2], tb, w0.x, w1.x, w2.x, bb.x),
                                          epilogue(acc[4 * j + 3], tb, w0.y, w1.y, w2.y, bb.y));
          }
          // 16 bytes a lane after a transpose across each quad; plain stores:
          // the slot is read back by this block right after the ray's tiles
          const int q = lane & 3;
#pragma unroll
          for (int j0 = 0; j0 + 4 <= BN / 8; j0 += 4) {
            uint32_t va[4] = {packed[2 * j0], packed[2 * j0 + 2], packed[2 * j0 + 4], packed[2 * j0 + 6]};
            uint32_t vb[4] = {packed[2 * j0 + 1], packed[2 * j0 + 3], packed[2 * j0 + 5], packed[2 * j0 + 7]};
            quad_transpose(va, q);
            quad_transpose(vb, q);
            *reinterpret_cast<uint4*>(oa + c * BN + 8 * (j0 + q)) = make_uint4(va[0], va[1], va[2], va[3]);
            *reinterpret_cast<uint4*>(ob + c * BN + 8 * (j0 + q)) = make_uint4(vb[0], vb[1], vb[2], vb[3]);
          }
#pragma unroll
          for (int j = BN / 32 * 4; j < BN / 8; ++j) {  // the groups left over: 4 bytes a lane
            *reinterpret_cast<uint32_t*>(oa + c * BN + 8 * j + q2) = packed[2 * j];
            *reinterpret_cast<uint32_t*>(ob + c * BN + 8 * j + q2) = packed[2 * j + 1];
          }

          // key head: kacc += rounded chunk (64 x 208, registers) @ fk chunk (208 x 128)
#pragma unroll
          for (int f = 0; f < F_STEPS; ++f) {
            mbar_wait(&full[stage], phase);
            const uint64_t db = sw128_desc(smem + stage * STAGE_BYTES + A_BYTES);
            pin(kacc);
            pin(packed);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < BK / 16; ++k) {
              const int s = f * (BK / 16) + k;
              if (s < BN / 16)
                wgmma_m64n128k16_rs(kacc, packed[4 * s], packed[4 * s + 1], packed[4 * s + 2], packed[4 * s + 3],
                                    db + 2 * k, c | s);
            }
            wgmma_commit();
            pin(kacc);
            if (f > 0) {
              wgmma_wait<1>();
              pin(kacc);
              if (lane == 0) mbar_arrive(&empty[prev]);
            }
            prev = stage;
            if (++stage == STAGES) { stage = 0; phase ^= 1; }
          }
          wgmma_wait<0>();
          pin(kacc);
          pin(packed);
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        float* ka = keys + (static_cast<size_t>(set) * vsp + ia) * HK;
        float* kb = ka + 8 * HK;
#pragma unroll
        for (int j = 0; j < HK / 8; ++j) {
          *reinterpret_cast<float2*>(ka + 8 * j + q2) = make_float2(kacc[4 * j], kacc[4 * j + 1]);
          *reinterpret_cast<float2*>(kb + 8 * j + q2) = make_float2(kacc[4 * j + 2], kacc[4 * j + 3]);
        }
      }
    }
    // the slot's rows go back through TMA (the async proxy): fence the
    // stores, then let the producer load them
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    consumers_sync();
    if (tid == 0) mbar_arrive(slot_ready);

    // ---------------- phase B: the round-1 logits, a 16-token tile a warp
    for (int q = cw; q * 16 < VS; q += CONSUMERS / 32) {
      const int ia = q * 16 + g, ib = ia + 8;
      uint32_t kA[chain::NK][4];
      const float* kpa = keys + static_cast<size_t>(ia) * HK;
      const float* kpb = keys + static_cast<size_t>(ib) * HK;
      // s row of natural token t = v*S + s: (V-1-v)*S + s
      const float* ksa = keys + (static_cast<size_t>(vsp) + (V - 1 - ia / S) * S + ia % S) * HK;
      const float* ksb = keys + (static_cast<size_t>(vsp) + (V - 1 - ib / S) * S + ib % S) * HK;
#pragma unroll
      for (int kk = 0; kk < chain::NK; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = kk * 16 + half * 8 + 2 * t4;
          kA[kk][half * 2] = ia < VS ? key_pair(kpa, ksa, fkb, col) : 0u;
          kA[kk][half * 2 + 1] = ib < VS ? key_pair(kpb, ksb, fkb, col) : 0u;
        }
      }
      const bf16* ra = ia < VS ? p.lc + token(ia) * chain::L : nullptr;
      const bf16* rb = ib < VS ? p.lc + token(ib) * chain::L : nullptr;
      uint32_t lcA[4], hA[chain::NK][4];
      chain::load_lc(ra, rb, lane, lcA);
      chain::hidden16<false>(lcA, wq, chain::LDL, bq, nullptr, lane, hA);
      float s0, s1;
      dots(kA, p.wk2t, bk2, hA, p.wq2t, bq2, lane, s0, s1);
      if (t4 == 0) {
        if (ia < VS) lg1[ia] = s0 * chain::kInvScale;
        if (ib < VS) lg1[ib] = s1 * chain::kInvScale;
      }
    }
    consumers_sync();
    if (cw == 0) softmax(lg1, VS, p.atwt + ray * VS, lane);
    consumers_sync();
    flip_weights(lg1);
    consumers_sync();
    weighted_sums(lg1);
    consumers_sync();
    values(z1, nullptr, 0.f);
    consumers_sync();
    small_product(z1, NZ, p.wenc, red);
    consumers_sync();
    if (tid < HK) ze[tid] = sum16(red, tid) + p.benc[tid];
    consumers_sync();
    small_product(ze, HK, p.wra, red);
    consumers_sync();
    if (tid < HK) zw[tid] = sum16(red, tid);
    consumers_sync();

    // ---------------- round-2 logits: 16-token tiles over the warps
    for (int q = cw; q * 16 < VS; q += CONSUMERS / 32) {
      const int ja = q * 16 + g, jb = ja + 8;
      const bf16* ra = ja < VS ? p.lc + token(ja) * chain::L : nullptr;
      const bf16* rb = jb < VS ? p.lc + token(jb) * chain::L : nullptr;
      uint32_t lcA[4], hA[chain::NK][4], qA[chain::NK][4];
      chain::load_lc(ra, rb, lane, lcA);
      chain::hidden16<false>(lcA, wq, chain::LDL, bq, nullptr, lane, hA);
      float zacc[chain::NJ][4];
#pragma unroll
      for (int j = 0; j < chain::NJ; ++j) {
        const int col = j * 8 + 2 * t4;
        zacc[j][0] = zacc[j][2] = zw[col];
        zacc[j][1] = zacc[j][3] = zw[col + 1];
      }
      chain::hidden16<true>(lcA, wrb, chain::LDL, brr, &zacc[0][0], lane, qA);
      float s0, s1;
      dots(qA, p.wr2t, br2, hA, p.wq2t, bq2, lane, s0, s1);
      if (t4 == 0) {
        if (ja < VS) lg2[ja] = s0 * chain::kInvScale;
        if (jb < VS) lg2[jb] = s1 * chain::kInvScale;
      }
    }
    consumers_sync();
    if (cw == 0) softmax(lg2, VS, nullptr, lane);
    consumers_sync();
    flip_weights(lg2);
    consumers_sync();
    weighted_sums(lg2);
    consumers_sync();
    // every slot read of this ray has completed (the ring's full barriers),
    // so the next ray's stores may follow
    values(p.zsum + ray * NZ, z1, static_cast<float>(V));
  }
}

}  // namespace rc
}  // namespace coponerf

extern "C" long long k6_scratch_bytes(int B, int V, int S, int N) {
  using namespace coponerf::rc;
  const long long rays = static_cast<long long>(B) * N;
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int vsp = (V * S + BM - 1) / BM * BM;
  return (rays < sms ? rays : sms) * static_cast<long long>(slot_bytes(vsp));
}

// V * S a ray that k6_render_core takes (its logit rows live in shared memory)
extern "C" int k6_max_tokens() { return coponerf::rc::MAX_TOKENS; }

// Sample sets p and s: four level tensors (B*V, S*N, {256, 256, 256, 64})
// and pt (B*V, S*N, 3), bf16, sample-major; the s rows view-flipped.  lc
// (B*V, S*N, 16) bf16.  w1t: W1's first 832 rows transposed (832 x 832,
// bf16); wt3: its three tanh rows (3 x 832, f32); fkat, fkbt: fka and fkb
// transposed (128 x 832, bf16); the chain weights transposed (out x in),
// bf16; biases f32.  Outputs f32: z_sum (B, N, 416), at_wt (B, N, V*S).
// scratch: k6_scratch_bytes(B, V, S, N) bytes of device memory.
extern "C" int k6_render_core(const void* s0p, const void* s1p, const void* s2p, const void* scp,
                              const void* ptp, const void* s0s, const void* s1s, const void* s2s,
                              const void* scs, const void* pts, const void* lc, const void* w1t,
                              const void* wt3, const void* w1b, const void* fkat, const void* fkbt,
                              const void* fkbias, const void* wk2t, const void* bk2, const void* wqt,
                              const void* bq, const void* wq2t, const void* bq2, const void* wra,
                              const void* wrbt, const void* brr, const void* wr2t, const void* br2,
                              const void* wenc, const void* benc, const void* flva, const void* flvb,
                              const void* flvbias, void* zsum, void* atwt, void* scratch, long long scratch_bytes,
                              int B, int V, int S, int N, void* stream) {
  using namespace coponerf::rc;
  using coponerf::chain::bf16;
  namespace hopper = coponerf::hopper;
  const long long rays = static_cast<long long>(B) * N;
  if (B < 0 || N < 0 || V <= 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rays == 0 || V * S == 0) return 0;
  const int VS = V * S, vsp = (VS + BM - 1) / BM * BM;
  const size_t bytes = smem_bytes(vsp);
  const long long need = k6_scratch_bytes(B, V, S, N);
  if (VS > MAX_TOKENS || bytes > 232448 || need < 0 || scratch_bytes < need ||
      static_cast<long long>(B) * VS > (1ll << 31) - BM)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  const void* lev[2][4] = {{s0p, s1p, s2p, scp}, {s0s, s1s, s2s, scs}};
  const int widths[4] = {C0, C0, C0, CC};
  bool ok = hopper::bf16_map(&maps.w, w1t, KX, NO, BN) && hopper::bf16_map(&maps.fk[0], fkat, NO, HK, HK) &&
            hopper::bf16_map(&maps.fk[1], fkbt, NO, HK, HK);
  for (int set = 0; set < 2; ++set)
    for (int i = 0; i < 4; ++i)
      ok = ok && hopper::bf16_map_3d(&maps.lev[set][i], lev[set][i], widths[i], N,
                                     static_cast<uint64_t>(B) * VS, 1, BM);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.pt[0] = static_cast<const bf16*>(ptp);
  p.pt[1] = static_cast<const bf16*>(pts);
  p.lc = static_cast<const bf16*>(lc);
  p.wt3 = static_cast<const float*>(wt3);
  p.w1b = static_cast<const float*>(w1b);
  p.fkbias = static_cast<const float*>(fkbias);
  p.wk2t = static_cast<const bf16*>(wk2t);
  p.bk2 = static_cast<const float*>(bk2);
  p.wqt = static_cast<const bf16*>(wqt);
  p.bq = static_cast<const float*>(bq);
  p.wq2t = static_cast<const bf16*>(wq2t);
  p.bq2 = static_cast<const float*>(bq2);
  p.wra = static_cast<const bf16*>(wra);
  p.wrbt = static_cast<const bf16*>(wrbt);
  p.brr = static_cast<const float*>(brr);
  p.wr2t = static_cast<const bf16*>(wr2t);
  p.br2 = static_cast<const float*>(br2);
  p.wenc = static_cast<const bf16*>(wenc);
  p.benc = static_cast<const float*>(benc);
  p.flva = static_cast<const bf16*>(flva);
  p.flvb = static_cast<const bf16*>(flvb);
  p.flvbias = static_cast<const float*>(flvbias);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.zsum = static_cast<float*>(zsum);
  p.atwt = static_cast<float*>(atwt);
  p.B = B;
  p.V = V;
  p.S = S;
  p.N = N;
  cudaError_t e = cudaFuncSetAttribute(render_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = need / static_cast<long long>(slot_bytes(vsp));
  render_core_kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}
