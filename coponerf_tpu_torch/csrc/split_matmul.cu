// K2: fused split-input dense + bias + relu, plus the folded key head.
//
// Replaces coponerf_tpu/ops/pallas/split_matmul.py:split_dense_relu
// (_forward / _kernel).  Computes, per token row m,
//   out[m] = relu(p0[m] W0 + p1[m] W1 + p2[m] W2 + pc[m] Wc
//                 + sum_j pt[m, j] Wt[j] + bias)          (rounded to T)
//   k[m]   = out[m] @ fk                                  (f32 sum, rounded to T)
// without materializing the (rows, 835) concat in device memory, and with
// the key product taken from the ROUNDED output, as the TPU kernel does.
// The 3-wide tanh part is three f32 products and adds in the epilogue, in
// the plain version's order (then the bias, then the relu).
//
// What bounds it on the H100: operations.  At stage A (1,048,576 rows,
// K = 832 + 3, N = 832, NK = 128) one bf16 call is ~1.68 TFLOP against
// ~3.8 GB of device-memory traffic, 445 FLOP a byte, above the bf16 ridge
// (~295); the f32 call of the exact path runs on the FMA units (no TF32:
// the exact path is held to ~1e-4), 15 times slower a FLOP.
//
// bf16 (split_dense_relu_bf16): wgmma fed by TMA, warp-specialised and
// persistent.  One block per SM walks 128-row tiles.  One producer thread
// keeps a ring of STAGES shared-memory stages in flight with mbarriers: each
// stage holds one 64-deep K slice of the tile's rows, loaded straight from
// the part tensor it lies in (one TMA descriptor a part, so the concat is
// never built), and the matching 208 x 64 slice of W (K-major, transposed
// by the wrapper), both with the 128-byte swizzle.  Two consumer
// warpgroups of 64 rows each issue wgmma m64n208k16 on the same W slice.
// A block owns all 832 columns of its rows, walked as 4 chunks of 208
// (832 = 4 x 208 keeps one instruction shape and a 104-register
// accumulator; 3 x 256 + 64 needs two shapes and 128 registers).  After a
// chunk's 13 K slices the consumers add the tanh products (its three W rows
// and the bias staged in shared memory once per block), apply the relu,
// round to bf16 in registers and store the chunk, 16 bytes a lane after a
// transpose within each quad of lanes, with streaming (evict-first) stores
// so that the output does not push W and the rows out of L2 (with plain
// stores the kernel took ~15 % longer on an H100 SXM at 700 W).  The
// rounded pairs, which sit in wgmma's accumulator layout, are the
// register-A operand of a second wgmma (m64n128k16) against the chunk's
// 208 rows of fk, streamed through the same ring.  The 64 x 128 f32 key accumulator (64 registers a thread) lives
// across the chunks, so the rounded output never goes through shared
// memory.  setmaxnreg gives the consumers 240 registers, the producer 24.
// W and fk (1.6 MB) stay in L2 and are re-read once per 128-row tile.
// What holds it back now: the two warpgroups run their epilogues (the
// tanh products, the rounding, the stores, the key head) in step, so the
// tensor cores wait meanwhile; without them the products alone ran at
// ~680 TFLOP/s on the same card.  Overlapping them needs a second
// accumulator (no registers left at 208 columns) or warpgroups out of
// step, which read W twice.
//
// f32 (split_dense_relu_f32): FMA units only.  A block of 128 threads owns
// 128 rows; each thread an 8 x 8 tile of a 128 x 64 block product, whose
// A and B slices (16 deep) are double buffered through shared memory from
// registers loaded one slice ahead, A transposed so that each float4
// shared load feeds 8 FMAs.  Pass 1 walks the 832 output columns in 13
// such blocks and stores them after the epilogue; pass 2 reads the block's
// own output rows back from L2 as the A operand of the key head, in two
// blocks of 64 key columns.  Three blocks share an SM (168 registers a
// thread, no spills).

#include "hopper.cuh"

namespace coponerf {

using bf16 = __nv_bfloat16;

constexpr int KNK = 128;  // key-head width the kernels are built for

// ------------------------------------------------------------------ bf16 --
namespace tc {
constexpr int BM = 128;                    // rows a tile: two consumer warpgroups of 64
constexpr int BN = 208;                    // output columns a chunk
constexpr int BK = 64;                     // one 128-byte swizzle row of bf16
constexpr int STAGES = 5;
constexpr int A_BYTES = BM * BK * 2;       // 16 KB of rows
constexpr int B_BYTES = BN * BK * 2;       // 26 KB of W (or 16 KB of fk)
constexpr int F_BYTES = KNK * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int F_STEPS = (BN + BK - 1) / BK;  // fk slices a chunk (the last one partly used)
constexpr int THREADS = 384;               // consumers: warps 0-7; producer: warps 8-11

__host__ __device__ inline size_t smem_bytes(int N) {
  return 1024 + static_cast<size_t>(STAGES) * STAGE_BYTES + 4ull * N * 4 + 2ull * STAGES * 8;
}
}  // namespace tc

// maps: the four parts (inner dimension K_i, outer M; 64 x 128 boxes), W
// transposed (inner Kmm, outer N; 64 x 208 boxes) and fk transposed (inner
// N, outer 128; 64 x 128 boxes), all with the 128-byte swizzle.  wt3 holds
// W's three tanh rows (3 x N, f32), bias N f32.
__global__ void __launch_bounds__(tc::THREADS, 1)
split_dense_relu_bf16(const __grid_constant__ CUtensorMap map_p0, const __grid_constant__ CUtensorMap map_p1,
                      const __grid_constant__ CUtensorMap map_p2, const __grid_constant__ CUtensorMap map_pc,
                      const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_fk,
                      const bf16* __restrict__ pt, const float* __restrict__ wt3, const float* __restrict__ bias,
                      bf16* __restrict__ out, bf16* __restrict__ kout, long long M, int K0, int Kc, int N) {
  using namespace tc;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled stages need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* wt_s = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* bias_s = wt_s + 3 * N;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + N);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * N; i += THREADS) wt_s[i] = wt3[i];
  for (int i = tid; i < N; i += THREADS) bias_s[i] = bias[i];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long tiles = (M + BM - 1) / BM;
  const int kbp = K0 / BK;             // K slices in each of p0, p1, p2
  const int KB = 3 * kbp + Kc / BK;    // K slices a chunk
  const int chunks = N / BN;

  if (tid >= 256) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = static_cast<int>(t * BM);
        for (int c = 0; c < chunks; ++c) {
          for (int kb = 0; kb < KB; ++kb) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = smem + stage * STAGE_BYTES;
            mbar_expect_tx(&full[stage], STAGE_BYTES);
            const int part = kb < 3 * kbp ? kb / kbp : 3;
            const CUtensorMap* map = part == 0 ? &map_p0 : part == 1 ? &map_p1 : part == 2 ? &map_p2 : &map_pc;
            tma_load_2d(st, map, &full[stage], (kb - part * kbp) * BK, row0);
            tma_load_2d(st + A_BYTES, &map_w, &full[stage], kb * BK, c * BN);
            if (++stage == STAGES) { stage = 0; phase ^= 1; }
          }
          for (int f = 0; f < F_STEPS; ++f) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], F_BYTES);
            tma_load_2d(smem + stage * STAGE_BYTES + A_BYTES, &map_fk, &full[stage], c * BN + f * BK, 0);
            if (++stage == STAGES) { stage = 0; phase ^= 1; }
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows wg * 64 .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int r_in = wg * 64 + warp * 16 + (lane >> 2);  // this thread's rows: r_in and r_in + 8
    const int q2 = (lane & 3) * 2;                       // and columns q2, q2 + 1 of each 8-column group
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long ra = t * BM + r_in, rb = ra + 8;
      float ta[3], tb[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ta[j] = ra < M ? __bfloat162float(pt[ra * 3 + j]) : 0.0f;
        tb[j] = rb < M ? __bfloat162float(pt[rb * 3 + j]) : 0.0f;
      }
      float kacc[64];
      for (int c = 0; c < chunks; ++c) {
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
        // chunk and keep the rounded pairs as the key head's A operand
        uint32_t packed[BN / 4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = c * BN + 8 * j + q2;
          const float2 w0 = *reinterpret_cast<const float2*>(wt_s + col);
          const float2 w1 = *reinterpret_cast<const float2*>(wt_s + N + col);
          const float2 w2 = *reinterpret_cast<const float2*>(wt_s + 2 * N + col);
          const float2 b = *reinterpret_cast<const float2*>(bias_s + col);
          packed[2 * j] = pack_bf16(epilogue(acc[4 * j], ta, w0.x, w1.x, w2.x, b.x),
                                    epilogue(acc[4 * j + 1], ta, w0.y, w1.y, w2.y, b.y));
          packed[2 * j + 1] = pack_bf16(epilogue(acc[4 * j + 2], tb, w0.x, w1.x, w2.x, b.x),
                                        epilogue(acc[4 * j + 3], tb, w0.y, w1.y, w2.y, b.y));
        }
        // store the chunk 16 bytes a lane: a transpose across each quad turns
        // four 8-column groups (4 bytes a lane each) into one group a lane.
        // Streaming stores (evict first): the output passes through L2
        // without pushing out W, fk and the tile's rows
        const int q = lane & 3;
        bf16* oa = out + ra * N + c * BN;
        bf16* ob = out + rb * N + c * BN;
#pragma unroll
        for (int j0 = 0; j0 + 4 <= BN / 8; j0 += 4) {
          uint32_t va[4] = {packed[2 * j0], packed[2 * j0 + 2], packed[2 * j0 + 4], packed[2 * j0 + 6]};
          uint32_t vb[4] = {packed[2 * j0 + 1], packed[2 * j0 + 3], packed[2 * j0 + 5], packed[2 * j0 + 7]};
          quad_transpose(va, q);
          quad_transpose(vb, q);
          if (ra < M) __stcs(reinterpret_cast<uint4*>(oa + 8 * (j0 + q)), make_uint4(va[0], va[1], va[2], va[3]));
          if (rb < M) __stcs(reinterpret_cast<uint4*>(ob + 8 * (j0 + q)), make_uint4(vb[0], vb[1], vb[2], vb[3]));
        }
#pragma unroll
        for (int j = BN / 32 * 4; j < BN / 8; ++j) {  // the groups left over: 4 bytes a lane
          if (ra < M) __stcs(reinterpret_cast<unsigned*>(oa + 8 * j + q2), packed[2 * j]);
          if (rb < M) __stcs(reinterpret_cast<unsigned*>(ob + 8 * j + q2), packed[2 * j + 1]);
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
#pragma unroll
      for (int j = 0; j < KNK / 8; ++j) {
        const int col = 8 * j + q2;
        if (ra < M) __stcs(reinterpret_cast<unsigned*>(kout + ra * KNK + col), pack_bf16(kacc[4 * j], kacc[4 * j + 1]));
        if (rb < M)
          __stcs(reinterpret_cast<unsigned*>(kout + rb * KNK + col), pack_bf16(kacc[4 * j + 2], kacc[4 * j + 3]));
      }
    }
  }
}

// ------------------------------------------------------------------- f32 --
namespace fm {
constexpr int BM = 128, BN = 64, BK = 16, THREADS = 128;
constexpr int LDA = BM + 4;  // transposed row slices, padded against bank conflicts

__host__ __device__ inline size_t smem_bytes(int N) {
  return (2ull * BK * LDA + 2ull * BK * BN + 4ull * N + BM * 3) * 4;
}

// acc (8 x 8 a thread: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j
// and 32 + tx*4 + j of a 128 x 64 block) = A (128 x K) @ B (K x 64).  A's
// rows come from a_src(k0, h) (four float4 a thread: rows lr + 32 h at
// K offset lk, zeros past M), B's 16-row slices from b_src(k0 + row): both
// double buffered through shared memory from registers loaded one slice
// ahead, A transposed so that every float4 shared load feeds 8 FMAs.
template <typename ASrc, typename BSrc>
__device__ __forceinline__ void gemm_block(float (&acc)[8][8], int K, float* As, float* Bs, ASrc a_src,
                                           BSrc b_src) {
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const int br = tid >> 4, bc = (tid & 15) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float4 ra[4], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 4; ++h) ra[h] = a_src(k0, h);
#pragma unroll
    for (int h = 0; h < 2; ++h) rb[h] = b_src(k0 + br + 8 * h, bc);
  };
  auto stage = [&](int buf) {
    float* a = As + buf * BK * LDA;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = lr + 32 * h;
      a[(lk + 0) * LDA + r] = ra[h].x;
      a[(lk + 1) * LDA + r] = ra[h].y;
      a[(lk + 2) * LDA + r] = ra[h].z;
      a[(lk + 3) * LDA + r] = ra[h].w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) *reinterpret_cast<float4*>(Bs + buf * BK * BN + (br + 8 * h) * BN + bc) = rb[h];
  };
  fetch(0);
  stage(0);
  __syncthreads();
  const int KT = K / BK;
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) fetch((kt + 1) * BK);
    const float* a = As + buf * BK * LDA;
    const float* b = Bs + buf * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * LDA + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * LDA + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + kk * BN + 32 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < KT) stage(buf ^ 1);
    __syncthreads();
  }
}
}  // namespace fm

// W is (Kmm, N) row-major, fk (N, 128), wt3 (3, N), all f32.  Pass 1 walks
// the output in chunks of 64 columns and stores them; pass 2 reads the
// block's output rows back (from L2, written by this block) as the A
// operand of the key head, in two halves of 64 key columns.
__global__ void __launch_bounds__(fm::THREADS, 3)
split_dense_relu_f32(const float* __restrict__ p0, const float* __restrict__ p1, const float* __restrict__ p2,
                     const float* __restrict__ pc, const float* __restrict__ pt, const float* __restrict__ W,
                     const float* __restrict__ wt3, const float* __restrict__ bias, const float* __restrict__ fk,
                     float* out, float* __restrict__ kout, long long M, int K0, int Kc, int N) {
  using namespace fm;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [2][BK][LDA]: row slices, k-major
  float* Bs = As + 2 * BK * LDA;                    // [2][BK][BN]: W or fk slices
  float* wt_s = Bs + 2 * BK * BN;                   // [3][N]
  float* bias_s = wt_s + 3 * N;                     // [N]
  float* ts = bias_s + N;                           // [BM][3]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int Kmm = 3 * K0 + Kc;
  for (int i = tid; i < 3 * N; i += THREADS) wt_s[i] = wt3[i];
  for (int i = tid; i < N; i += THREADS) bias_s[i] = bias[i];
  for (int i = tid; i < BM * 3; i += THREADS) {
    const long long row = m0 + i / 3;
    ts[i] = row < M ? pt[row * 3 + i % 3] : 0.0f;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[8][8];

  // pass 1: out = relu(parts @ W + tanh products + bias), 64 columns at a time
  auto parts = [&](int k0, int h) {
    const float* src = pc;
    int width = Kc, col = k0 - 3 * K0;
    if (k0 < K0) { src = p0; width = K0; col = k0; }
    else if (k0 < 2 * K0) { src = p1; width = K0; col = k0 - K0; }
    else if (k0 < 3 * K0) { src = p2; width = K0; col = k0 - 2 * K0; }
    const long long row = m0 + lr + 32 * h;
    return row < M ? *reinterpret_cast<const float4*>(src + row * width + col + lk) : zero;
  };
  for (int n0 = 0; n0 < N; n0 += BN) {
    gemm_block(acc, Kmm, As, Bs, parts, [&](int k, int c) {
      return *reinterpret_cast<const float4*>(W + static_cast<long long>(k) * N + n0 + c);
    });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + (j < 4 ? 0 : 32) + tx * 4 + (j & 3);
        acc[i][j] = epilogue(acc[i][j], ts + r * 3, wt_s[col], wt_s[N + col], wt_s[2 * N + col], bias_s[col]);
      }
      if (m0 + r < M) {
        const float lo[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
        const float hi[4] = {acc[i][4], acc[i][5], acc[i][6], acc[i][7]};
        store16(out + (m0 + r) * N + n0 + tx * 4, lo);
        store16(out + (m0 + r) * N + n0 + 32 + tx * 4, hi);
      }
    }
  }

  // pass 2: k = out @ fk from the rows just stored (visible to the whole
  // block after this barrier; read through L2, not the read-only path)
  __syncthreads();
  auto outs = [&](int k0, int h) {
    const long long row = m0 + lr + 32 * h;
    return row < M ? __ldcg(reinterpret_cast<const float4*>(out + row * N + k0 + lk)) : zero;
  };
  for (int h0 = 0; h0 < KNK; h0 += BN) {
    gemm_block(acc, N, As, Bs, outs, [&](int k, int c) {
      return *reinterpret_cast<const float4*>(fk + static_cast<long long>(k) * KNK + h0 + c);
    });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long row = m0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      if (row >= M) continue;
      const float lo[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      const float hi[4] = {acc[i][4], acc[i][5], acc[i][6], acc[i][7]};
      store16(kout + row * KNK + h0 + tx * 4, lo);
      store16(kout + row * KNK + h0 + 32 + tx * 4, hi);
    }
  }
}

}  // namespace coponerf

// bf16: W is the matmul rows of the kernel TRANSPOSED, (N, Kmm), and fk
// transposed, (NK, N); f32: W is (Kmm, N) and fk (N, NK).  wt3 (3, N) and
// bias (N) are f32 for both.
extern "C" int k2_split_dense_relu(const void* p0, const void* p1, const void* p2, const void* pc,
                                   const void* pt, const void* W, const void* wt3, const void* bias,
                                   const void* fk, void* out, void* k, long long M, int K0, int Kc, int N,
                                   int NK, int dtype, void* stream) {
  using namespace coponerf;
  if (NK != KNK || K0 <= 0 || Kc <= 0 || M < 0 || M > (1ll << 31) - 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const size_t bytes = tc::smem_bytes(N);
    if (N % tc::BN != 0 || K0 % tc::BK != 0 || Kc % tc::BK != 0 || bytes > 232448)
      return static_cast<int>(cudaErrorInvalidValue);
    if (M == 0) return 0;
    const int Kmm = 3 * K0 + Kc;
    CUtensorMap maps[6];
    using hopper::bf16_map;
    const bool ok = bf16_map(&maps[0], p0, K0, M, tc::BM) && bf16_map(&maps[1], p1, K0, M, tc::BM) &&
                    bf16_map(&maps[2], p2, K0, M, tc::BM) && bf16_map(&maps[3], pc, Kc, M, tc::BM) &&
                    bf16_map(&maps[4], W, Kmm, N, tc::BN) && bf16_map(&maps[5], fk, N, KNK, KNK);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(split_dense_relu_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    const long long tiles = (M + tc::BM - 1) / tc::BM;
    const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
    split_dense_relu_bf16<<<grid, tc::THREADS, bytes, s>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<const bf16*>(pt),
        static_cast<const float*>(wt3), static_cast<const float*>(bias), static_cast<bf16*>(out),
        static_cast<bf16*>(k), M, K0, Kc, N);
  } else {
    const size_t bytes = fm::smem_bytes(N);
    if (N % fm::BN != 0 || K0 % fm::BK != 0 || Kc % fm::BK != 0 || bytes > 232448)
      return static_cast<int>(cudaErrorInvalidValue);
    if (M == 0) return 0;
    cudaError_t e = cudaFuncSetAttribute(split_dense_relu_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long blocks = (M + fm::BM - 1) / fm::BM;
    split_dense_relu_f32<<<static_cast<unsigned>(blocks), fm::THREADS, bytes, s>>>(
        static_cast<const float*>(p0), static_cast<const float*>(p1), static_cast<const float*>(p2),
        static_cast<const float*>(pc), static_cast<const float*>(pt), static_cast<const float*>(W),
        static_cast<const float*>(wt3), static_cast<const float*>(bias), static_cast<const float*>(fk),
        static_cast<float*>(out), static_cast<float*>(k), M, K0, Kc, N);
  }
  return static_cast<int>(cudaGetLastError());
}
