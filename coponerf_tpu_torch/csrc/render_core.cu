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
// What bounds it on the H100: operations (W1 is ~0.36 GFLOP a ray at S 64,
// V 2, against ~0.23 MB of samples).  No 832-wide activation reaches device
// memory.  A ray's pre-activations (2 x V*S x 832 bf16, 426 KB at S 64) do
// not fit one SM's shared memory, so the block makes two passes over W1:
//   pass 1, per chunk of 32 tokens: W1 of the p rows (resident input rows,
//     cp.async double-buffered W1 tiles, wmma bf16, as K2) into a bf16 chunk
//     buffer, the fka fold from the rounded chunk; the same for the matching
//     flipped s rows; the round-1 chain on the chunk's keys (attn_chain.cuh);
//     then an online softmax that rescales and accumulates both weighted sums
//     from the two chunk buffers;
//   then z1, ze and the round-2 logits of every token (lc and ze only), and
//     their softmax;
//   pass 2: W1 again, chunk by chunk, accumulating the round-2 weighted sums.
// The 832 -> 416 value products run on the per-ray vectors (SIMT, weights
// from L2).  One block per SM (~220 KB of shared memory), persistent over
// the rays.  A thread-block cluster sharing the pre-activations through
// distributed shared memory would remove the second W1 pass.

#include <math.h>
#include <mma.h>

#include "attn_chain.cuh"

namespace coponerf {
namespace rc {

using namespace nvcuda;
using chain::bf16;

constexpr int kThreads = 256;
constexpr int MT = 32;              // tokens of one sample set per chunk
constexpr int C0 = 256, CC = 64;    // level widths: three UFC levels, conv_map
constexpr int KX = 3 * C0 + CC;     // 832 sampled channels
constexpr int NO = 832;             // W1 output width
constexpr int NZ = 416;             // value width
constexpr int HK = 128;             // key width
constexpr int BN = 64, BK = 32;
constexpr int LDX = KX + 8, LDW = BN + 8, LDC = BN + 4, LDF = HK + 8, LDK = HK + 4;

struct Params {
  const bf16* lev_p[4];
  const bf16* pt_p;
  const bf16* lev_s[4];
  const bf16* pt_s;
  const bf16* lc;
  const bf16* w1;      // (835, 832)
  const float* w1b;
  const bf16* fka;     // (832, 128)
  const bf16* fkb;
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
  float* zsum;         // (B, N, 416)
  float* atwt;         // (B, N, V*S)
  int B, V, S, N;
};

// shared memory layout (byte offsets); every region is 32-byte aligned
constexpr size_t kX = 0;
constexpr size_t kPP = kX + MT * LDX * 2;
constexpr size_t kPS = kPP + MT * LDX * 2;
constexpr size_t kWs = kPS + MT * LDX * 2;
constexpr size_t kCs = kWs + 2 * BK * LDW * 2;
constexpr size_t kFs = kCs + MT * LDC * 4;          // fk tile; then the chunk's bf16 keys
constexpr size_t kKs = kFs + BN * LDF * 2;
constexpr size_t kTs = kKs + MT * LDK * 4;
constexpr size_t kUA = kTs + MT * 3 * 4;
constexpr size_t kUB = kUA + NO * 4;
constexpr size_t kZ1 = kUB + NO * 4;
constexpr size_t kZE = kZ1 + NZ * 4;
constexpr size_t kZW = kZE + HK * 4;
constexpr size_t kRed = kZW + HK * 4;
constexpr size_t kEx = kRed + MT * 4 * 4;
constexpr size_t kStat = kEx + MT * 4;
constexpr size_t kLg = kStat + 32;                  // two logit rows of VSP floats

__host__ __device__ inline size_t smem_bytes(int vsp) { return kLg + 2 * static_cast<size_t>(vsp) * 4; }

__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ long long token(const Params& p, int b, int v, int s, int n) {
  return ((static_cast<long long>(b) * p.V + v) * p.S + s) * p.N + n;
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// W1 on the chunk's MT tokens j0.. of one sample set (view rows flipped for
// the s set): relu(. + b1) rounded to bf16 into P (MT x LDX); with kFold
// also kacc += P @ fk (this warp's 16 x 32 part of the MT x 128 keys).
template <bool kFold>
__device__ void w1_chunk(const Params& p, const bf16* const* lev, const bf16* pt, bool flip, int b, int n,
                         int j0, int VS, unsigned char* sm, bf16* P, const bf16* fk, Acc (&kacc)[2]) {
  bf16* X = reinterpret_cast<bf16*>(sm + kX);
  bf16* Ws = reinterpret_cast<bf16*>(sm + kWs);
  float* Cs = reinterpret_cast<float*>(sm + kCs);
  bf16* Fs = reinterpret_cast<bf16*>(sm + kFs);
  float* Ts = reinterpret_cast<float*>(sm + kTs);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1;

  // resident input rows: the virtual concat of the four levels, 16 B at a time
  constexpr int units = KX / 8;
  for (int u = tid; u < MT * units; u += kThreads) {
    const int i = u / units, col = (u - i * units) * 8;
    bf16* dst = X + i * LDX + col;
    const int j = j0 + i;
    if (j >= VS) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const int v = j / p.S, s = j - v * p.S;
    const long long t = token(p, b, flip ? p.V - 1 - v : v, s, n);
    const bf16* src;
    if (col < C0) src = lev[0] + t * C0 + col;
    else if (col < 2 * C0) src = lev[1] + t * C0 + (col - C0);
    else if (col < 3 * C0) src = lev[2] + t * C0 + (col - 2 * C0);
    else src = lev[3] + t * CC + (col - 3 * C0);
    cp_async16(dst, src);
  }
  for (int u = tid; u < MT * 3; u += kThreads) {
    const int i = u / 3, j = j0 + i;
    float x = 0.f;
    if (j < VS) {
      const int v = j / p.S, s = j - v * p.S;
      const long long t = token(p, b, flip ? p.V - 1 - v : v, s, n);
      x = tanhf(__fdiv_rn(__bfloat162float(pt[t * 3 + (u - i * 3)]), 5.0f));
    }
    Ts[u] = x;
  }
  cp_async_commit();

  constexpr int KT = KX / BK, NC = NO / BN, n_tiles = NC * KT;
  auto issue_w = [&](int it) {
    const int nc = it / KT, kt = it - (it / KT) * KT;
    const int r = tid >> 3, c = (tid & 7) * 8;  // 32 rows x 8 vectors
    cp_async16(Ws + (it & 1) * BK * LDW + r * LDW + c,
               p.w1 + static_cast<long long>(kt * BK + r) * NO + nc * BN + c);
    cp_async_commit();
  };
  issue_w(0);

  for (int nc = 0; nc < NC; ++nc) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kt = 0; kt < KT; ++kt) {
      const int it = nc * KT + kt;
      if (it + 1 < n_tiles) {
        issue_w(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* wbuf = Ws + (it & 1) * BK * LDW;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> w;
        wmma::load_matrix_sync(a, X + (warp_m * 16) * LDX + kt * BK + kk * 16, LDX);
        wmma::load_matrix_sync(w, wbuf + (kk * 16) * LDW + warp_n * 16, LDW);
        wmma::mma_sync(acc, a, w, acc);
      }
      __syncthreads();
    }

    // epilogue: the tanh FMAs and bias in f32, relu, round
    wmma::store_matrix_sync(Cs + (warp_m * 16) * LDC + warp_n * 16, acc, LDC, wmma::mem_row_major);
    if (kFold) {
      for (int u = tid; u < BN * (HK / 8); u += kThreads) {
        const int r = u / (HK / 8), c = (u % (HK / 8)) * 8;
        *reinterpret_cast<uint4*>(Fs + r * LDF + c) =
            *reinterpret_cast<const uint4*>(fk + static_cast<long long>(nc * BN + r) * HK + c);
      }
    }
    __syncthreads();
    {
      const int r = tid >> 3, c = (tid & 7) * 8;  // 32 rows x 8 vectors
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = nc * BN + c + e;
        float a = Cs[r * LDC + c + e];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          a = __fadd_rn(a, __fmul_rn(Ts[r * 3 + q], __bfloat162float(p.w1[static_cast<long long>(KX + q) * NO + col])));
        v[e] = fmaxf(__fadd_rn(a, p.w1b[col]), 0.0f);
      }
      store16(P + r * LDX + nc * BN + c, v);
    }
    __syncthreads();
    if (kFold) {  // keys from the rounded chunk: kacc += P[:, chunk] (32 x 64) @ Fs (64 x 128)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, P + (warp_m * 16) * LDX + nc * BN + kk * 16, LDX);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> w;
          wmma::load_matrix_sync(w, Fs + (kk * 16) * LDF + warp_n * 32 + f * 16, LDF);
          wmma::mma_sync(kacc[f], a, w, kacc[f]);
        }
      }
    }
  }
  __syncthreads();
}

// acc[c] = acc[c] * alpha + sum_t e[t] * P[t, c] over the chunk's MT tokens,
// for all NO columns (e[t] = 0 for tokens past the ray's V * S)
__device__ __forceinline__ void accumulate(float* acc, const bf16* P, const float* e, float alpha) {
  for (int c = threadIdx.x; c < NO; c += kThreads) {
    float a = acc[c] * alpha;
#pragma unroll 8
    for (int t = 0; t < MT; ++t) a = fmaf(e[t], __bfloat162float(P[t * LDX + c]), a);
    acc[c] = a;
  }
}

// z[c] = sum_k bf16(ua[k]) flva[k, c] + sum_k bf16(ub[k]) flvb[k, c] + bias[c];
// ua and ub already hold their bf16 values.  Two adjacent columns a thread.
__device__ __forceinline__ void values(const Params& p, const float* ua, const float* ub, float* z,
                                       const float* add, float add_scale) {
  const int pair = threadIdx.x;
  if (pair >= NZ / 2) return;
  const int c = pair * 2;
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll 4
  for (int k = 0; k < NO; ++k) {
    const float2 wa = chain::unpack(chain::ldg32(p.flva + static_cast<long long>(k) * NZ + c));
    const float2 wb = chain::unpack(chain::ldg32(p.flvb + static_cast<long long>(k) * NZ + c));
    a0 = fmaf(ua[k], wa.x, a0);
    a1 = fmaf(ua[k], wa.y, a1);
    b0 = fmaf(ub[k], wb.x, b0);
    b1 = fmaf(ub[k], wb.y, b1);
  }
  float z0 = (a0 + b0) + p.flvbias[c], z1 = (a1 + b1) + p.flvbias[c + 1];
  if (add) {
    z0 += add_scale * add[c];
    z1 += add_scale * add[c + 1];
  }
  z[c] = z0;
  z[c + 1] = z1;
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

__global__ void __launch_bounds__(kThreads, 1) render_core_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* PP = reinterpret_cast<bf16*>(sm + kPP);
  bf16* PS = reinterpret_cast<bf16*>(sm + kPS);
  bf16* KP = reinterpret_cast<bf16*>(sm + kFs);
  float* Ks = reinterpret_cast<float*>(sm + kKs);
  float* ua = reinterpret_cast<float*>(sm + kUA);
  float* ub = reinterpret_cast<float*>(sm + kUB);
  float* z1 = reinterpret_cast<float*>(sm + kZ1);
  float* ze = reinterpret_cast<float*>(sm + kZE);
  float* zw = reinterpret_cast<float*>(sm + kZW);
  float* red = reinterpret_cast<float*>(sm + kRed);
  float* ex = reinterpret_cast<float*>(sm + kEx);
  float* stat = reinterpret_cast<float*>(sm + kStat);  // running max, sum, rescale
  const int VS = p.V * p.S;
  const int vsp = (VS + MT - 1) / MT * MT;
  float* lg1 = reinterpret_cast<float*>(sm + kLg);
  float* lg2 = lg1 + vsp;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_chunks = vsp / MT;
  const long long rays = static_cast<long long>(p.B) * p.N;

  for (long long ray = blockIdx.x; ray < rays; ray += gridDim.x) {
    const int b = static_cast<int>(ray / p.N), n = static_cast<int>(ray - static_cast<long long>(b) * p.N);
    for (int c = tid; c < NO; c += kThreads) ua[c] = ub[c] = 0.f;
    if (tid == 0) {
      stat[0] = -INFINITY;
      stat[1] = 0.f;
    }

    // ---------------- pass 1: keys, round-1 logits, online softmax sums
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int j0 = ch * MT;
      Acc kacc[2];
      wmma::fill_fragment(kacc[0], 0.0f);
      wmma::fill_fragment(kacc[1], 0.0f);
      w1_chunk<true>(p, p.lev_p, p.pt_p, false, b, n, j0, VS, sm, PP, p.fka, kacc);
#pragma unroll
      for (int f = 0; f < 2; ++f)
        wmma::store_matrix_sync(Ks + (warp_m * 16) * LDK + warp_n * 32 + f * 16, kacc[f], LDK,
                                wmma::mem_row_major);
      wmma::fill_fragment(kacc[0], 0.0f);
      wmma::fill_fragment(kacc[1], 0.0f);
      w1_chunk<true>(p, p.lev_s, p.pt_s, true, b, n, j0, VS, sm, PS, p.fkb, kacc);
#pragma unroll
      for (int f = 0; f < 2; ++f) {  // this warp's own tiles of Ks: ka + kb
        Acc ka;
        float* at = Ks + (warp_m * 16) * LDK + warp_n * 32 + f * 16;
        wmma::load_matrix_sync(ka, at, LDK, wmma::mem_row_major);
#pragma unroll
        for (int e = 0; e < ka.num_elements; ++e) ka.x[e] = ka.x[e] + kacc[f].x[e];
        wmma::store_matrix_sync(at, ka, LDK, wmma::mem_row_major);
      }
      __syncthreads();
      for (int u = tid; u < MT * HK; u += kThreads) {
        const int r = u / HK, c = u - r * HK;
        KP[r * LDF + c] = __float2bfloat16_rn(fmaxf(Ks[r * LDK + c] + p.fkbias[c], 0.f));
      }
      __syncthreads();

      {  // round-1 chain: warp (rg, cq) takes 16 tokens x 4 of the 16 output tiles
        const int rg = warp & 1, cq = warp >> 1;
        const int ia = rg * 16 + g, ib = ia + 8;
        const int ja = j0 + ia, jb = j0 + ib;
        const bf16* ra = nullptr;
        const bf16* rb = nullptr;
        if (ja < VS) ra = p.lc + token(p, b, ja / p.S, ja % p.S, n) * chain::L;
        if (jb < VS) rb = p.lc + token(p, b, jb / p.S, jb % p.S, n) * chain::L;
        uint32_t lcA[4], hA[chain::NK][4], kA[chain::NK][4];
        chain::load_lc(ra, rb, lane, lcA);
        chain::hidden16<false>(lcA, p.wqt, chain::L, p.bq, nullptr, lane, hA);
#pragma unroll
        for (int kk = 0; kk < chain::NK; ++kk) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int col = kk * 16 + half * 8 + 2 * t4;
            kA[kk][half * 2] = *reinterpret_cast<const uint32_t*>(KP + ia * LDF + col);
            kA[kk][half * 2 + 1] = *reinterpret_cast<const uint32_t*>(KP + ib * LDF + col);
          }
        }
        float s0, s1;
        chain::dot_rows<4>(kA, p.wk2t, p.bk2, hA, p.wq2t, p.bq2, chain::H, cq * 4, lane, s0, s1);
        if (t4 == 0) {
          red[ia * 4 + cq] = s0;
          red[ib * 4 + cq] = s1;
        }
      }
      __syncthreads();
      if (warp == 0) {  // the chunk's logits and the online-softmax update
        const int j = j0 + lane;
        float l = -INFINITY;
        if (j < VS) {
          l = (((red[lane * 4] + red[lane * 4 + 1]) + red[lane * 4 + 2]) + red[lane * 4 + 3]) * chain::kInvScale;
          lg1[j] = l;
        }
        const float m_old = stat[0];
        const float m_new = fmaxf(m_old, warp_max(l));
        const float e = j < VS ? expf(l - m_new) : 0.f;
        const float se = warp_sum(e);
        ex[lane] = e;
        if (lane == 0) {
          const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
          stat[0] = m_new;
          stat[1] = stat[1] * alpha + se;
          stat[2] = alpha;
        }
      }
      __syncthreads();
      accumulate(ua, PP, ex, stat[2]);
      accumulate(ub, PS, ex, stat[2]);
      __syncthreads();
    }

    // ---------------- the round-1 weights, z1, ze and ze @ wra
    {
      const float m = stat[0], Z = stat[1];
      float* aw = p.atwt + ray * VS;
      for (int j = tid; j < VS; j += kThreads) aw[j] = expf(lg1[j] - m) / Z;
      for (int c = tid; c < NO; c += kThreads) {
        ua[c] = bfr(ua[c] / Z);
        ub[c] = bfr(ub[c] / Z);
      }
    }
    __syncthreads();
    values(p, ua, ub, z1, nullptr, 0.f);
    __syncthreads();
    if (tid < HK) {
      float a = 0.f;
      for (int k = 0; k < NZ; ++k) a = fmaf(bfr(z1[k]), __bfloat162float(p.wenc[k * HK + tid]), a);
      ze[tid] = a + p.benc[tid];
    }
    __syncthreads();
    if (tid < HK) {
      float a = 0.f;
      for (int k = 0; k < HK; ++k) a = fmaf(bfr(ze[k]), __bfloat162float(p.wra[k * HK + tid]), a);
      zw[tid] = a;
    }
    __syncthreads();

    // ---------------- round-2 logits: 16-token tiles over the warps
    for (int q = warp; q * 16 < VS; q += kThreads / 32) {
      const int ja = q * 16 + g, jb = ja + 8;
      const bf16* ra = nullptr;
      const bf16* rb = nullptr;
      if (ja < VS) ra = p.lc + token(p, b, ja / p.S, ja % p.S, n) * chain::L;
      if (jb < VS) rb = p.lc + token(p, b, jb / p.S, jb % p.S, n) * chain::L;
      uint32_t lcA[4], hA[chain::NK][4], qA[chain::NK][4];
      chain::load_lc(ra, rb, lane, lcA);
      chain::hidden16<false>(lcA, p.wqt, chain::L, p.bq, nullptr, lane, hA);
      float zacc[chain::NJ][4];
#pragma unroll
      for (int j = 0; j < chain::NJ; ++j) {
        const int col = j * 8 + 2 * t4;
        zacc[j][0] = zacc[j][2] = zw[col];
        zacc[j][1] = zacc[j][3] = zw[col + 1];
      }
      chain::hidden16<true>(lcA, p.wrbt, chain::L, p.brr, &zacc[0][0], lane, qA);
      float s0, s1;
      chain::dot_rows<chain::NJ>(qA, p.wr2t, p.br2, hA, p.wq2t, p.bq2, chain::H, 0, lane, s0, s1);
      if (t4 == 0) {
        if (ja < VS) lg2[ja] = s0 * chain::kInvScale;
        if (jb < VS) lg2[jb] = s1 * chain::kInvScale;
      }
    }
    __syncthreads();
    if (warp == 0) {  // softmax over the V * S tokens, in place
      float m = -INFINITY;
      for (int j = lane; j < VS; j += 32) m = fmaxf(m, lg2[j]);
      m = warp_max(m);
      float z = 0.f;
      for (int j = lane; j < VS; j += 32) z += expf(lg2[j] - m);
      z = warp_sum(z);
      for (int j = lane; j < VS; j += 32) lg2[j] = expf(lg2[j] - m) / z;
    }
    for (int c = tid; c < NO; c += kThreads) ua[c] = ub[c] = 0.f;
    __syncthreads();

    // ---------------- pass 2: W1 again, the round-2 weighted sums
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int j0 = ch * MT;
      if (tid < MT) ex[tid] = j0 + tid < VS ? lg2[j0 + tid] : 0.f;
      Acc unused[2];
      w1_chunk<false>(p, p.lev_p, p.pt_p, false, b, n, j0, VS, sm, PP, nullptr, unused);
      accumulate(ua, PP, ex, 1.f);
      __syncthreads();
      w1_chunk<false>(p, p.lev_s, p.pt_s, true, b, n, j0, VS, sm, PP, nullptr, unused);
      accumulate(ub, PP, ex, 1.f);
      __syncthreads();
    }
    for (int c = tid; c < NO; c += kThreads) {
      ua[c] = bfr(ua[c]);
      ub[c] = bfr(ub[c]);
    }
    __syncthreads();
    values(p, ua, ub, p.zsum + ray * NZ, z1, static_cast<float>(p.V));
    __syncthreads();
  }
}

}  // namespace rc
}  // namespace coponerf

// Sample sets p and s: four level tensors (B*V, S*N, {256, 256, 256, 64})
// and pt (B*V, S*N, 3), bf16, sample-major; the s rows view-flipped.  lc
// (B*V, S*N, 16) bf16.  Weights bf16 (the chain weights transposed, out x
// in), biases f32.  Outputs f32: z_sum (B, N, 416), at_wt (B, N, V*S).
extern "C" int k6_render_core(const void* s0p, const void* s1p, const void* s2p, const void* scp,
                              const void* ptp, const void* s0s, const void* s1s, const void* s2s,
                              const void* scs, const void* pts, const void* lc, const void* w1,
                              const void* w1b, const void* fka, const void* fkb, const void* fkbias,
                              const void* wk2t, const void* bk2, const void* wqt, const void* bq,
                              const void* wq2t, const void* bq2, const void* wra, const void* wrbt,
                              const void* brr, const void* wr2t, const void* br2, const void* wenc,
                              const void* benc, const void* flva, const void* flvb, const void* flvbias,
                              void* zsum, void* atwt, int B, int V, int S, int N, void* stream) {
  using namespace coponerf::rc;
  using coponerf::chain::bf16;
  const long long rays = static_cast<long long>(B) * N;
  if (rays == 0 || V * S == 0) return 0;
  Params p;
  const void* lp[4] = {s0p, s1p, s2p, scp};
  const void* ls[4] = {s0s, s1s, s2s, scs};
  for (int i = 0; i < 4; ++i) {
    p.lev_p[i] = static_cast<const bf16*>(lp[i]);
    p.lev_s[i] = static_cast<const bf16*>(ls[i]);
  }
  p.pt_p = static_cast<const bf16*>(ptp);
  p.pt_s = static_cast<const bf16*>(pts);
  p.lc = static_cast<const bf16*>(lc);
  p.w1 = static_cast<const bf16*>(w1);
  p.w1b = static_cast<const float*>(w1b);
  p.fka = static_cast<const bf16*>(fka);
  p.fkb = static_cast<const bf16*>(fkb);
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
  p.zsum = static_cast<float*>(zsum);
  p.atwt = static_cast<float*>(atwt);
  p.B = B;
  p.V = V;
  p.S = S;
  p.N = N;
  const int vsp = (V * S + MT - 1) / MT * MT;
  const size_t bytes = smem_bytes(vsp);
  cudaError_t e = cudaFuncSetAttribute(render_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = static_cast<int>(rays < sms ? rays : sms);
  render_core_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
