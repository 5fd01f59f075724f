// K6: the post-sampling render core: each ray's attention in turn, its value
// products a group of rays at a time.
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
// persistent block per SM takes a contiguous share of the rays and walks it
// in groups of G rays (64 at V * S <= 128, 64 / ceil(V * S / 128) above:
// the wrapper's group_rays); one producer thread keeps a ring of 4
// shared-memory stages in flight with TMA and mbarriers; two consumer
// warpgroups (setmaxnreg 240 / 24) run wgmma m64n208k16 on 128-row tiles.
// A tile is 128 tokens of one sample set of one ray (one tile a set at
// V * S <= 128).  A ray's tokens are strided in the (B*V, S*N, C) level
// tensors, so each level is read through a 3-D map {C, N, B*V*S} whose box
// {64, 1, 128} at (k0, n, b*V*S + 128 * tile) lands token v*S + s in row
// v*S + s of the swizzled tile.  Rows past V * S (the next ray's tokens,
// or TMA's zero fill at the end) are computed and then weigh 0.  The
// epilogue adds the tanh products and the bias, applies the relu, rounds
// to bf16 in registers and stores the tile with plain stores into the
// ray's slot (one of the block's G) in device memory; the rounded pairs
// are the register-A operand of the key head (fka for p tiles, fkb for s
// tiles), whose f32 partials go to the block's one copy of the key
// partials (round 1 alone reads them).
//
// The tail runs on the 256 consumer threads alone, on a named barrier.
// Its large reads go through the same ring: once the consumers have fenced
// their slot stores (fence.proxy.async) and arrived on slot_ready, the
// producer queues the slot's pre-activation rows (16 a slice) as bulk
// copies for each weighted sum, so TMA keeps up to 4 slices in flight,
// also while the consumers run the chains.  Round 1, ray by ray: kpre from
// the two key partials (p token (v, s) pairs with s row (V-1-v)*S + s);
// the chain, a 16-token tile a warp (attn_chain.cuh, inlined: out of line
// its fragments came from local memory at every mma and it took twice as
// long; its biases and 16-deep weights in shared memory, the 128 x 128
// ones from L2); the exact softmax and at_wt; the weighted sums, rounded to
// bf16 into the ray's row of the group's table U (64 x 1664: ua | ub).
// The value path, a group at a time: once the group's rows are in U (the
// same fence, u_ready), Z1 = U @ [flva; flvb] + flv_bias is one wgmma
// product of 64 rows (rows past the group's rays are computed and never
// written): each K slice of 64 is two ring stages, each U's slice by TMA
// and one half of the transposed weights (416 x 1664, boxes 64 x 208);
// warpgroup w takes columns 208 w.. of both.  Z1 stays in scratch in f32;
// ze = bf16(Z1) @ wenc + benc runs from the accumulators as register A
// (each warpgroup its 208-deep half, the halves summed through scratch),
// then zw = bf16(ze) @ wra (each warpgroup 64 of its columns) into scratch.
// Round 2, ray by ray on the slots, which the group still holds: the chain
// (zw's row), its softmax and weighted sums into U; then the same product
// writes z_sum = U @ [flva; flvb] + flv_bias + V * Z1 at the group's rays.
// The weights of the value path are read once a group, not once a ray.
//
// Scratch: U of every block (64 x 1664 bf16), then each block's G slots
// (2 x vsp x 832 bf16 each, vsp = V * S rounded up to 128), the key
// partials (2 x vsp x 128 f32), Z1 (64 x 416 f32), ze's two halves and zw
// (64 x 128 f32 each): 27.8 MB a block at V * S 128, 3.67 GB on 132 SMs.
//
// What holds it back (a clock probe of each step, a 32768-ray chunk at
// S 64 on an H100 SXM at 700 W, PERF.md): 69.3-69.6 ms a chunk against
// the per-ray value path's 80.3 in turns; of a probed 68.9 ms, W1 and the
// key heads 32.4 (their wgmma serialized), the round-1 and round-2 chains
// 14.2 and 11.0 (8 warps, one tile each, their 128 x 128 weights from L2),
// the weighted sums 5.2 and 4.9, the softmaxes 0.8 and the value path 0.54
// (15.6 when it ran a ray at a time).

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
constexpr int BN = 208;             // output columns a chunk; a warpgroup's half of the values
constexpr int BK = kBoxK;           // K depth of a ring slice
constexpr int STAGES = 4;           // ring stages: the tail's vectors leave no room for a fifth
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int F_BYTES = HK * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int F_STEPS = (BN + BK - 1) / BK;  // fk (and wenc) slices of 208 deep (the last one partly used)
constexpr int CHUNKS = NO / BN;
constexpr int KBP = C0 / BK;                 // K slices of each 256-wide level
constexpr int KB = KX / BK;                  // K slices a chunk
constexpr int CONSUMERS = 256;               // warps 0-7; the producer: warps 8-11
constexpr int THREADS = CONSUMERS + 128;
constexpr int kBar = 1;                      // the consumers' named barrier
constexpr int MAX_TOKENS = 1024;             // V * S a ray: its logit rows live in shared memory
constexpr int WS_ROWS = 16;                  // slot rows a ring slice of the weighted sums
constexpr int WS_BYTES = WS_ROWS * NO * 2;
constexpr int GM = 64;                       // rows of a group's value product: one wgmma tile
constexpr int KV = 2 * NO;                   // its depth: ua | ub
constexpr int KVB = KV / BK;                 // its K slices, two ring stages each
constexpr int VP_BYTES = GM * BK * 2 + B_BYTES;  // a stage of it: U's slice, one half of the weights
static_assert(WS_BYTES <= STAGE_BYTES && 2 * F_BYTES <= STAGE_BYTES && GM * BK * 2 <= A_BYTES && 2 * BN == NZ &&
                  KV % BK == 0,
              "tail slices fit a stage");

// a ray's slot: the rounded pre-activations of both sets (2 x vsp x 832
// bf16), rows of the s set in its tensor (view-flipped) order
__host__ __device__ inline size_t slot_bytes(int vsp) { return static_cast<size_t>(vsp) * 2 * NO * 2; }

// a block's rows of U, the group's weighted sums
constexpr size_t U_BYTES = static_cast<size_t>(GM) * KV * 2;

// the rest of a block's scratch: G slots, one ray's key partials (2 x vsp x
// 128 f32), Z1 (64 x 416 f32), ze's two halves and zw (64 x 128 f32 each)
__host__ __device__ inline size_t block_bytes(int vsp, int G) {
  return G * slot_bytes(vsp) + static_cast<size_t>(vsp) * 2 * HK * 4 + static_cast<size_t>(GM) * (NZ + 3 * HK) * 4;
}

// shared memory: the ring (1024-aligned), W1's tanh rows and bias, the
// barriers, then the two logit rows, the s set's weights in slot order,
// the chain biases and the two 16-deep chain weights
__host__ __device__ inline size_t smem_bytes(int vsp) {
  return 1024 + static_cast<size_t>(STAGES) * STAGE_BYTES + 4ull * NO * 4 + (2ull * STAGES + 2) * 8 + 6ull * HK * 4 +
         3ull * vsp * 4 + 2ull * HK * chain::LDL * 2;
}

struct Maps {
  CUtensorMap lev[2][4];  // each set's levels as {C, N, B*V*S}, boxes 64 x 1 x 128
  CUtensorMap w;          // W1's first 832 rows transposed (832 x 832), boxes 64 x 208
  CUtensorMap fk[2];      // fka, fkb transposed (128 x 832), boxes 64 x 128
  CUtensorMap u;          // every block's U (64 rows a block x 1664), boxes 64 x 64
  CUtensorMap wv;         // [flva; flvb] transposed (416 x 1664), boxes 64 x 208
  CUtensorMap wenc;       // wenc transposed (128 x 416), boxes 64 x 128
  CUtensorMap wra;        // wra transposed (128 x 128), boxes 64 x 128
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
  const bf16* wrbt;
  const float* brr;
  const bf16* wr2t;
  const float* br2;
  const float* benc;
  const float* flvbias;
  bf16* u;             // gridDim.x tables U
  unsigned char* own;  // then each block's block_bytes
  size_t block_bytes;
  float* zsum;         // (B, N, 416)
  float* atwt;         // (B, N, V*S)
  int B, V, S, N, G;
};

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

// relu(kp + ks + bias) of two adjacent key columns, rounded to a bf16 pair
__device__ __forceinline__ uint32_t key_pair(const float* kp, const float* ks, const float* bias, int col) {
  const float2 a = __ldcg(reinterpret_cast<const float2*>(kp + col));
  const float2 c = __ldcg(reinterpret_cast<const float2*>(ks + col));
  return chain::pack(fmaxf((a.x + c.x) + bias[col], 0.f), fmaxf((a.y + c.y) + bias[col + 1], 0.f));
}

// the consumers' place in the ring
struct Ring {
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// shared memory past the ring: W1's tanh rows and bias, then the barriers
__device__ __forceinline__ float* tanh_rows(unsigned char* smem) {
  return reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
}
__device__ __forceinline__ uint64_t* full_bars(unsigned char* smem) {
  return reinterpret_cast<uint64_t*>(tanh_rows(smem) + 4 * NO);
}

// phase A of one ray: W1 and the key heads of every tile, into the ray's
// slot and the key partials.  tok0: the ray's token 0 in the token tensors
// (token t = v*S + s is tok0 + t * N)
__device__ __forceinline__ Ring phase_a(unsigned char* smem, Ring r, const bf16* pt0, const bf16* pt1, bf16* slot,
                                   float* keys, long long tok0, int N, int VS, int vsp) {
  const float* wt_s = tanh_rows(smem);
  const float* bias_s = wt_s + 3 * NO;
  uint64_t* full = full_bars(smem);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_in = wg * 64 + warp * 16 + (lane >> 2);  // this thread's tile rows: r_in and r_in + 8
  const int q2 = (lane & 3) * 2;                       // and columns q2, q2 + 1 of each 8-column group
  for (int set = 0; set < 2; ++set) {
    const bf16* pt = set ? pt1 : pt0;
    for (int t = 0; t < vsp / BM; ++t) {
      const int ia = t * BM + r_in, ib = ia + 8;  // slot rows
      float ta[3], tb[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ta[j] = ia < VS ? tanhf(__fdiv_rn(__bfloat162float(pt[(tok0 + static_cast<long long>(ia) * N) * 3 + j]), 5.0f))
                        : 0.f;
        tb[j] = ib < VS ? tanhf(__fdiv_rn(__bfloat162float(pt[(tok0 + static_cast<long long>(ib) * N) * 3 + j]), 5.0f))
                        : 0.f;
      }
      bf16* oa = slot + (static_cast<size_t>(set) * vsp + ia) * NO;
      bf16* ob = oa + 8 * NO;
      float kacc[64];
      for (int c = 0; c < CHUNKS; ++c) {
        // the chunk's product: 13 K slices, one wgmma group in flight
        float acc[BN / 2];
        int prev = 0;
        for (int kb = 0; kb < KB; ++kb) {
          mbar_wait(&full[r.stage], r.phase);
          const unsigned char* st = smem + r.stage * STAGE_BYTES;
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
          prev = r.stage;
          r.advance();
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
        // 16 bytes a lane after a transpose across each quad; plain stores
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
          mbar_wait(&full[r.stage], r.phase);
          const uint64_t db = sw128_desc(smem + r.stage * STAGE_BYTES + A_BYTES);
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
          prev = r.stage;
          r.advance();
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
  return r;
}

// acc (the group's 64 rows x this warpgroup's 208 columns) = U @ [flva;
// flvb]: a K slice is two stages, this warpgroup's the first or the second
__device__ __forceinline__ Ring value_product(unsigned char* smem, Ring r, float (&acc)[BN / 2]) {
  uint64_t* full = full_bars(smem);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  int p0 = 0, p1 = 0;
  for (int kb = 0; kb < KVB; ++kb) {
    const Ring r0 = r;
    r.advance();
    const Ring r1 = r;
    r.advance();
    mbar_wait(&full[r0.stage], r0.phase);
    mbar_wait(&full[r1.stage], r1.phase);
    const unsigned char* st = smem + (wg ? r1.stage : r0.stage) * STAGE_BYTES;
    const uint64_t da = sw128_desc(st), db = sw128_desc(st + A_BYTES);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) wgmma_m64n208k16_ss(acc, da + 2 * k, db + 2 * k, kb | k);
    wgmma_commit();
    pin(acc);
    if (kb > 0) {
      wgmma_wait<1>();
      pin(acc);
      if (lane == 0) {
        mbar_arrive(&empty[p0]);
        mbar_arrive(&empty[p1]);
      }
    }
    p0 = r0.stage;
    p1 = r1.stage;
  }
  wgmma_wait<0>();
  pin(acc);
  if (lane == 0) {
    mbar_arrive(&empty[p0]);
    mbar_arrive(&empty[p1]);
  }
  return r;
}

// round 1's value path for the group: Z1 = U @ [flva; flvb] + flv_bias into
// z1 (64 x 416), then ze = bf16(Z1) @ wenc + benc and zw = bf16(ze) @ wra
// into zw (64 x 128), both from registers; zep: ze's two halves
__device__ __forceinline__ Ring group_z1(unsigned char* smem, Ring r, const float* flvbias, const float* benc, float* z1,
                                  float* zep, float* zw) {
  uint64_t* full = full_bars(smem);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8, q2 = (lane & 3) * 2;  // rows and columns of the product
  float acc[BN / 2];
  r = value_product(smem, r, acc);
  uint32_t packed[BN / 4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = wg * BN + 8 * j + q2;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(flvbias + col));
    const float2 za = make_float2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
    const float2 zb = make_float2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
    *reinterpret_cast<float2*>(z1 + ra * NZ + col) = za;
    *reinterpret_cast<float2*>(z1 + rb * NZ + col) = zb;
    packed[2 * j] = pack_bf16(za.x, za.y);
    packed[2 * j + 1] = pack_bf16(zb.x, zb.y);
  }
  // this warpgroup's 208-deep half of ze: a stage holds both halves' wenc slices
  float ze[HK / 2];
  int prev = 0;
#pragma unroll
  for (int f = 0; f < F_STEPS; ++f) {
    mbar_wait(&full[r.stage], r.phase);
    const uint64_t db = sw128_desc(smem + r.stage * STAGE_BYTES + wg * F_BYTES);
    pin(ze);
    pin(packed);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const int s = f * (BK / 16) + k;
      if (s < BN / 16)
        wgmma_m64n128k16_rs(ze, packed[4 * s], packed[4 * s + 1], packed[4 * s + 2], packed[4 * s + 3], db + 2 * k, s);
    }
    wgmma_commit();
    pin(ze);
    if (f > 0) {
      wgmma_wait<1>();
      pin(ze);
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  pin(ze);
  pin(packed);
  if (lane == 0) mbar_arrive(&empty[prev]);
  // the two halves meet in scratch; each warpgroup then holds all of ze at its positions
  float* mine = zep + wg * GM * HK;
  const float* other = zep + (1 - wg) * GM * HK;
#pragma unroll
  for (int j = 0; j < HK / 8; ++j) {
    const int col = 8 * j + q2;
    *reinterpret_cast<float2*>(mine + ra * HK + col) = make_float2(ze[4 * j], ze[4 * j + 1]);
    *reinterpret_cast<float2*>(mine + rb * HK + col) = make_float2(ze[4 * j + 2], ze[4 * j + 3]);
  }
  consumers_sync();
  uint32_t zp[HK / 4];
#pragma unroll
  for (int j = 0; j < HK / 8; ++j) {
    const int col = 8 * j + q2;
    const float2 oa = __ldcg(reinterpret_cast<const float2*>(other + ra * HK + col));
    const float2 ob = __ldcg(reinterpret_cast<const float2*>(other + rb * HK + col));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(benc + col));
    zp[2 * j] = pack_bf16((ze[4 * j] + oa.x) + bb.x, (ze[4 * j + 1] + oa.y) + bb.y);
    zp[2 * j + 1] = pack_bf16((ze[4 * j + 2] + ob.x) + bb.x, (ze[4 * j + 3] + ob.y) + bb.y);
  }
  // zw's columns 64 wg..: the stage holds wra's two 64-deep slices
  float zacc[HK / 4];
  mbar_wait(&full[r.stage], r.phase);
  const unsigned char* st = smem + r.stage * STAGE_BYTES;
  pin(zacc);
  pin(zp);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < HK / 16; ++s) {
    const uint64_t db = sw128_desc(st + (s >> 2) * F_BYTES + wg * 64 * 128) + 2 * (s & 3);
    wgmma_m64n64k16_rs(zacc, zp[4 * s], zp[4 * s + 1], zp[4 * s + 2], zp[4 * s + 3], db, s);
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(zacc);
  pin(zp);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[r.stage]);
  r.advance();
#pragma unroll
  for (int j = 0; j < HK / 16; ++j) {
    const int col = wg * 64 + 8 * j + q2;
    *reinterpret_cast<float2*>(zw + ra * HK + col) = make_float2(zacc[4 * j], zacc[4 * j + 1]);
    *reinterpret_cast<float2*>(zw + rb * HK + col) = make_float2(zacc[4 * j + 2], zacc[4 * j + 3]);
  }
  return r;
}

// round 2's value path for the group: z_sum = U @ [flva; flvb] + flv_bias +
// vf * Z1 into the rows of its gn rays (zsum: the first one's)
__device__ __forceinline__ Ring group_zsum(unsigned char* smem, Ring r, const float* flvbias, const float* z1, float* zsum,
                                    int gn, float vf) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8, q2 = (lane & 3) * 2;
  float acc[BN / 2];
  r = value_product(smem, r, acc);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = wg * BN + 8 * j + q2;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(flvbias + col));
    if (ra < gn) {
      const float2 za = *reinterpret_cast<const float2*>(z1 + ra * NZ + col);
      *reinterpret_cast<float2*>(zsum + ra * NZ + col) =
          make_float2((acc[4 * j] + bb.x) + vf * za.x, (acc[4 * j + 1] + bb.y) + vf * za.y);
    }
    if (rb < gn) {
      const float2 zb = *reinterpret_cast<const float2*>(z1 + rb * NZ + col);
      *reinterpret_cast<float2*>(zsum + rb * NZ + col) =
          make_float2((acc[4 * j + 2] + bb.x) + vf * zb.x, (acc[4 * j + 3] + bb.y) + vf * zb.y);
    }
  }
  return r;
}

__global__ void __launch_bounds__(THREADS, 1) render_core_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled stages need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* wt_s = tanh_rows(smem);
  float* bias_s = wt_s + 3 * NO;
  uint64_t* full = full_bars(smem);
  uint64_t* empty = full + STAGES;
  uint64_t* slot_ready = empty + STAGES;  // the ray's pre-activations are in its slot
  uint64_t* u_ready = slot_ready + 1;     // the group's rows are in U
  float* lg1 = reinterpret_cast<float*>(slot_ready + 2);  // 16-byte aligned from here on
  const int V = p.V, S = p.S, N = p.N, VS = V * S, G = p.G;
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
    mbar_init(u_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's rays, [lo, hi), in groups of G
  const long long rays = static_cast<long long>(p.B) * N;
  const int lo = static_cast<int>(rays * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(rays * (blockIdx.x + 1) / gridDim.x);
  const size_t slot_elems = slot_bytes(vsp) / 2;
  unsigned char* own = p.own + blockIdx.x * p.block_bytes;
  bf16* slots = reinterpret_cast<bf16*>(own);
  float* keys = reinterpret_cast<float*>(own + G * slot_bytes(vsp));
  float* z1 = keys + 2 * static_cast<size_t>(vsp) * HK;  // the group's Z1 (64 x 416)
  float* zep = z1 + GM * NZ;                             // ze's two 208-deep halves (2 x 64 x 128)
  float* zw = zep + 2 * GM * HK;                         // zw (64 x 128)
  bf16* urows = p.u + static_cast<size_t>(blockIdx.x) * GM * KV;
  if (tid >= CONSUMERS) {
    // producer: one thread issues every load into the ring, in the order
    // the consumers take them: per group, per ray the W1 slices of its
    // tiles and the slot's rows for round 1's weighted sums; the value
    // product's slices, wenc's and wra's; per ray the slot's rows for round
    // 2's weighted sums; the value product's slices
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      Ring r{0, 0};
      uint32_t sphase = 0, uphase = 0;
      auto next = [&]() -> unsigned char* {
        mbar_wait(&empty[r.stage], r.phase ^ 1);
        return smem + r.stage * STAGE_BYTES;
      };
      auto slot_rows = [&](const bf16* slot) {
        for (int set = 0; set < 2; ++set)
          for (int i = 0; i < nws; ++i) {
            unsigned char* st = next();
            mbar_expect_tx(&full[r.stage], WS_BYTES);
            bulk_load(st, slot + (static_cast<size_t>(set) * vsp + i * WS_ROWS) * NO, WS_BYTES, &full[r.stage]);
            r.advance();
          }
      };
      // each K slice of U twice, beside each half of the transposed weights
      auto value_slices = [&]() {
        mbar_wait(u_ready, uphase);  // the consumers' stores of U are done and fenced
        uphase ^= 1;
        for (int kb = 0; kb < KVB; ++kb)
          for (int h = 0; h < 2; ++h) {
            unsigned char* st = next();
            mbar_expect_tx(&full[r.stage], VP_BYTES);
            tma_load_2d(st, &maps.u, &full[r.stage], kb * BK, blockIdx.x * GM);
            tma_load_2d(st + A_BYTES, &maps.wv, &full[r.stage], kb * BK, h * BN);
            r.advance();
          }
      };
      for (int g0 = lo; g0 < hi; g0 += G) {
        const int gn = min(G, hi - g0);
        for (int i = 0; i < gn; ++i) {
          const int ray = g0 + i;
          const int b = ray / N, n = ray - b * N;
          for (int set = 0; set < 2; ++set) {
            for (int t = 0; t < tiles; ++t) {
              const int row0 = b * VS + t * BM;
              for (int c = 0; c < CHUNKS; ++c) {
                for (int kb = 0; kb < KB; ++kb) {
                  unsigned char* st = next();
                  mbar_expect_tx(&full[r.stage], STAGE_BYTES);
                  const int part = kb < 3 * KBP ? kb / KBP : 3;
                  tma_load_3d(st, &maps.lev[set][part], &full[r.stage], (kb - part * KBP) * BK, n, row0);
                  tma_load_2d(st + A_BYTES, &maps.w, &full[r.stage], kb * BK, c * BN);
                  r.advance();
                }
                for (int f = 0; f < F_STEPS; ++f) {
                  unsigned char* st = next();
                  mbar_expect_tx(&full[r.stage], F_BYTES);
                  tma_load_2d(st + A_BYTES, &maps.fk[set], &full[r.stage], c * BN + f * BK, 0);
                  r.advance();
                }
              }
            }
          }
          mbar_wait(slot_ready, sphase);  // the consumers' slot stores are done and fenced
          sphase ^= 1;
          slot_rows(slots + i * slot_elems);
        }
        value_slices();
        // ze: each warpgroup's 208-deep half of wenc, slice by slice; zw: wra whole
        for (int f = 0; f < F_STEPS; ++f) {
          unsigned char* st = next();
          mbar_expect_tx(&full[r.stage], 2 * F_BYTES);
          tma_load_2d(st, &maps.wenc, &full[r.stage], f * BK, 0);
          tma_load_2d(st + F_BYTES, &maps.wenc, &full[r.stage], BN + f * BK, 0);
          r.advance();
        }
        unsigned char* st = next();
        mbar_expect_tx(&full[r.stage], 2 * F_BYTES);
        tma_load_2d(st, &maps.wra, &full[r.stage], 0, 0);
        tma_load_2d(st + F_BYTES, &maps.wra, &full[r.stage], BK, 0);
        r.advance();
        for (int i = 0; i < gn; ++i) slot_rows(slots + i * slot_elems);
        value_slices();
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int lane = tid & 31, cw = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  Ring r{0, 0};

  // the tail's ring slices: wait for the next one; hand it back once every
  // lane of the warp has read it
  auto next_slice = [&]() -> const unsigned char* {
    mbar_wait(&full[r.stage], r.phase);
    return smem + r.stage * STAGE_BYTES;
  };
  auto free_slice = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[r.stage]);
    r.advance();
  };
  // the ray's row of U: ua = bf16(sum_t w[t] pre_p[t, :]), ub = bf16(sum_t
  // w[t] pre_s[flip(t), :]): the slot's rows stream through the ring, 4
  // columns a thread
  auto weighted_sums = [&](const float* w, bf16* u) {
    for (int set = 0; set < 2; ++set) {
      const float* ws = set ? wfl : w;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < nws; ++i) {
        const bf16* rows = reinterpret_cast<const bf16*>(next_slice());
        if (tid < NO / 4) {
#pragma unroll 4
          for (int j = 0; j < WS_ROWS; ++j) {
            const float x = ws[i * WS_ROWS + j];
            const uint2 q = *reinterpret_cast<const uint2*>(rows + j * NO + 4 * tid);
            const float2 f0 = chain::unpack(q.x), f1 = chain::unpack(q.y);
            acc[0] = fmaf(x, f0.x, acc[0]);
            acc[1] = fmaf(x, f0.y, acc[1]);
            acc[2] = fmaf(x, f1.x, acc[2]);
            acc[3] = fmaf(x, f1.y, acc[3]);
          }
        }
        free_slice();
      }
      if (tid < NO / 4)
        *reinterpret_cast<uint2*>(u + set * NO + 4 * tid) =
            make_uint2(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]));
    }
  };
  // the s set's slot row i = (V-1-v)*S + s weighs as token v*S + s
  auto flip_weights = [&](const float* w) {
    for (int i = tid; i < VS; i += CONSUMERS) wfl[i] = w[(V - 1 - i / S) * S + i % S];
  };
  // the slot's or U's rows go back through TMA (the async proxy): fence
  // the stores, then let the producer load them
  auto rows_ready = [&](uint64_t* bar) {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    consumers_sync();
    if (tid == 0) mbar_arrive(bar);
  };

  for (int g0 = lo; g0 < hi; g0 += G) {
    const int gn = min(G, hi - g0);
    // ---------------- round 1, ray by ray
    for (int i = 0; i < gn; ++i) {
      const int ray = g0 + i;
      const int b = ray / N, n = ray - b * N;
      const long long tok0 = static_cast<long long>(b) * VS * N + n;  // token t = v*S + s: tok0 + t * N
      r = phase_a(smem, r, p.pt[0], p.pt[1], slots + i * slot_elems, keys, tok0, N, VS, vsp);
      rows_ready(slot_ready);

      // the round-1 logits, a 16-token tile a warp
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
        const bf16* lra = ia < VS ? p.lc + (tok0 + static_cast<long long>(ia) * N) * chain::L : nullptr;
        const bf16* lrb = ib < VS ? p.lc + (tok0 + static_cast<long long>(ib) * N) * chain::L : nullptr;
        uint32_t lcA[4], hA[chain::NK][4];
        chain::load_lc(lra, lrb, lane, lcA);
        chain::hidden16<false>(lcA, wq, chain::LDL, bq, nullptr, lane, hA);
        float s0, s1;
        chain::dot_rows<chain::NJ>(kA, p.wk2t, bk2, hA, p.wq2t, bq2, chain::H, 0, lane, s0, s1);
        if (t4 == 0) {
          if (ia < VS) lg1[ia] = s0 * chain::kInvScale;
          if (ib < VS) lg1[ib] = s1 * chain::kInvScale;
        }
      }
      consumers_sync();
      if (cw == 0) softmax(lg1, VS, p.atwt + static_cast<long long>(ray) * VS, lane);
      consumers_sync();
      flip_weights(lg1);
      consumers_sync();
      weighted_sums(lg1, urows + i * KV);
      consumers_sync();
    }

    // ---------------- the group's Z1, ze and zw
    rows_ready(u_ready);
    r = group_z1(smem, r, p.flvbias, p.benc, z1, zep, zw);
    consumers_sync();

    // ---------------- round 2, ray by ray on the held slots
    for (int i = 0; i < gn; ++i) {
      const int ray = g0 + i;
      const int b = ray / N, n = ray - b * N;
      const long long tok0 = static_cast<long long>(b) * VS * N + n;
      const float* zwr = zw + i * HK;
      for (int q = cw; q * 16 < VS; q += CONSUMERS / 32) {
        const int ja = q * 16 + g, jb = ja + 8;
        const bf16* lra = ja < VS ? p.lc + (tok0 + static_cast<long long>(ja) * N) * chain::L : nullptr;
        const bf16* lrb = jb < VS ? p.lc + (tok0 + static_cast<long long>(jb) * N) * chain::L : nullptr;
        uint32_t lcA[4], hA[chain::NK][4], qA[chain::NK][4];
        chain::load_lc(lra, lrb, lane, lcA);
        chain::hidden16<false>(lcA, wq, chain::LDL, bq, nullptr, lane, hA);
        float zacc[chain::NJ][4];
#pragma unroll
        for (int j = 0; j < chain::NJ; ++j) {
          const float2 z = __ldcg(reinterpret_cast<const float2*>(zwr + j * 8 + 2 * t4));
          zacc[j][0] = zacc[j][2] = z.x;
          zacc[j][1] = zacc[j][3] = z.y;
        }
        chain::hidden16<true>(lcA, wrb, chain::LDL, brr, &zacc[0][0], lane, qA);
        float s0, s1;
        chain::dot_rows<chain::NJ>(qA, p.wr2t, br2, hA, p.wq2t, bq2, chain::H, 0, lane, s0, s1);
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
      weighted_sums(lg2, urows + i * KV);
      consumers_sync();
    }

    // ---------------- the group's z_sum; every slot read of the group has
    // completed (the ring's full barriers), so the next group's stores may follow
    rows_ready(u_ready);
    r = group_zsum(smem, r, p.flvbias, z1, p.zsum + static_cast<size_t>(g0) * NZ, gn, static_cast<float>(V));
  }
}

}  // namespace rc
}  // namespace coponerf

// Scratch bytes of one k6_render_core launch on the current device, in
// groups of G rays (1..64): min(SMs, B*N) blocks of U_BYTES + block_bytes.
extern "C" long long k6_scratch_bytes(int B, int V, int S, int N, int G) {
  using namespace coponerf::rc;
  const long long rays = static_cast<long long>(B) * N;
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  if (G < 1 || G > GM) return -1;
  const int vsp = (V * S + BM - 1) / BM * BM;
  return (rays < sms ? rays : sms) * static_cast<long long>(U_BYTES + block_bytes(vsp, G));
}

// V * S a ray that k6_render_core takes (its logit rows live in shared memory)
extern "C" int k6_max_tokens() { return coponerf::rc::MAX_TOKENS; }

// Sample sets p and s: four level tensors (B*V, S*N, {256, 256, 256, 64})
// and pt (B*V, S*N, 3), bf16, sample-major; the s rows view-flipped.  lc
// (B*V, S*N, 16) bf16.  w1t: W1's first 832 rows transposed (832 x 832,
// bf16); wt3: its three tanh rows (3 x 832, f32); fkat, fkbt: fka and fkb
// transposed (128 x 832, bf16); the chain weights, wenc and wra transposed
// (out x in), bf16; wvt: [flva; flvb] transposed (416 x 1664, bf16);
// biases f32.  Outputs f32: z_sum (B, N, 416), at_wt (B, N, V*S).
// scratch: k6_scratch_bytes(B, V, S, N, G) bytes of device memory; G the
// rays of a value product (1..64).
extern "C" int k6_render_core(const void* s0p, const void* s1p, const void* s2p, const void* scp,
                              const void* ptp, const void* s0s, const void* s1s, const void* s2s,
                              const void* scs, const void* pts, const void* lc, const void* w1t,
                              const void* wt3, const void* w1b, const void* fkat, const void* fkbt,
                              const void* fkbias, const void* wk2t, const void* bk2, const void* wqt,
                              const void* bq, const void* wq2t, const void* bq2, const void* wrat,
                              const void* wrbt, const void* brr, const void* wr2t, const void* br2,
                              const void* venct, const void* benc, const void* wvt, const void* flvbias,
                              void* zsum, void* atwt, void* scratch, long long scratch_bytes, int B, int V, int S,
                              int N, int G, void* stream) {
  using namespace coponerf::rc;
  using coponerf::chain::bf16;
  namespace hopper = coponerf::hopper;
  const long long rays = static_cast<long long>(B) * N;
  if (B < 0 || N < 0 || V <= 0 || S < 0 || G < 1 || G > GM) return static_cast<int>(cudaErrorInvalidValue);
  if (rays == 0 || V * S == 0) return 0;
  const int VS = V * S, vsp = (VS + BM - 1) / BM * BM;
  const size_t bytes = smem_bytes(vsp);
  const long long need = k6_scratch_bytes(B, V, S, N, G);
  if (VS > MAX_TOKENS || bytes > 232448 || need < 0 || scratch_bytes < need ||
      static_cast<long long>(B) * VS > (1ll << 31) - BM)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = need / static_cast<long long>(U_BYTES + block_bytes(vsp, G));
  Maps maps;
  const void* lev[2][4] = {{s0p, s1p, s2p, scp}, {s0s, s1s, s2s, scs}};
  const int widths[4] = {C0, C0, C0, CC};
  bool ok = hopper::bf16_map(&maps.w, w1t, KX, NO, BN) && hopper::bf16_map(&maps.fk[0], fkat, NO, HK, HK) &&
            hopper::bf16_map(&maps.fk[1], fkbt, NO, HK, HK) &&
            hopper::bf16_map(&maps.u, scratch, KV, static_cast<uint64_t>(blocks) * GM, GM) &&
            hopper::bf16_map(&maps.wv, wvt, KV, NZ, BN) && hopper::bf16_map(&maps.wenc, venct, NZ, HK, HK) &&
            hopper::bf16_map(&maps.wra, wrat, HK, HK, HK);
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
  p.wrbt = static_cast<const bf16*>(wrbt);
  p.brr = static_cast<const float*>(brr);
  p.wr2t = static_cast<const bf16*>(wr2t);
  p.br2 = static_cast<const float*>(br2);
  p.benc = static_cast<const float*>(benc);
  p.flvbias = static_cast<const float*>(flvbias);
  p.u = static_cast<bf16*>(scratch);
  p.own = static_cast<unsigned char*>(scratch) + blocks * U_BYTES;
  p.block_bytes = block_bytes(vsp, G);
  p.zsum = static_cast<float*>(zsum);
  p.atwt = static_cast<float*>(atwt);
  p.B = B;
  p.V = V;
  p.S = S;
  p.N = N;
  p.G = G;
  cudaError_t e = cudaFuncSetAttribute(render_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  render_core_kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}
