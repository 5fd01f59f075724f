// K2: fused split-input dense + bias + relu, plus the folded key head.
//
// Replaces coponerf_tpu/ops/pallas/split_matmul.py:split_dense_relu
// (_forward / _kernel).  Computes, per token row m,
//   out[m] = relu(p0[m] W0 + p1[m] W1 + p2[m] W2 + pc[m] Wc
//                 + sum_j pt[m, j] Wt[j] + bias)          (rounded to T)
//   k[m]   = out[m] @ fk                                  (f32 sum, rounded to T)
// without materializing the (rows, 835) concat in device memory, and with
// the key product taken from the ROUNDED output tile, as the TPU kernel does.
//
// What bounds it on the H100: FLOPs.  At the main-path shape (1,048,576 rows,
// K = 832 + 3, N = 832, NK = 128) one call is ~1.7 TFLOP against ~2.6 GB of
// traffic, far above the bf16 ridge (~295 FLOP/byte), so it belongs on the
// tensor cores.  This first version uses nvcuda::wmma (mma.sync) bf16
// fragments with f32 accumulation: one block owns 64 rows and ALL 832
// output columns, keeps its 64 x 832 input rows resident in shared memory
// (every part streamed from device memory once), walks the output in 64-wide
// column chunks with a cp.async double-buffered W tile, and feeds each
// rounded 64 x 64 output chunk straight into the 64 x 128 key accumulator,
// which therefore needs no second pass and no atomics.  The 3-wide tanh
// part is done as f32 FMAs in the epilogue.  wgmma/TMA and a persistent
// schedule are later work.  The f32 variant (exact path) is a SIMT loop over
// the same tiling.

#include <mma.h>

#include "common.cuh"

namespace coponerf {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int KNK = 128;  // key-head width the kernel is built for

// ------------------------------------------------------------------ bf16 --
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDW = BN + 8, LDC = BN + 4, LDO = BN + 8, LDF = KNK + 8, LDK = KNK + 4;

// the first region holds the resident input rows, and at the end the f32
// key accumulator (whichever is larger)
__host__ __device__ inline size_t bf16_region_a(int Kmm) {
  const size_t rows = static_cast<size_t>(BM) * (Kmm + 8) * 2, keys = static_cast<size_t>(BM) * LDK * 4;
  return rows > keys ? rows : keys;
}

__host__ __device__ inline size_t bf16_smem_bytes(int Kmm) {
  return bf16_region_a(Kmm) + 2ull * BK * LDW * 2 + BM * LDC * 4 + BM * LDO * 2 + BN * LDF * 2 +
         BM * 3 * 4;
}

__global__ void __launch_bounds__(256)
split_dense_relu_bf16(const bf16* __restrict__ p0, const bf16* __restrict__ p1,
                      const bf16* __restrict__ p2, const bf16* __restrict__ pc,
                      const bf16* __restrict__ pt, const bf16* __restrict__ Wt,
                      const float* __restrict__ bias, const bf16* __restrict__ fk,
                      bf16* __restrict__ out, bf16* __restrict__ kout, long long M, int K0,
                      int Kc, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Kmm = 3 * K0 + Kc;
  const int LDA = Kmm + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = reinterpret_cast<bf16*>(smem + bf16_region_a(Kmm));
  float* Cs = reinterpret_cast<float*>(Ws + 2 * BK * LDW);
  bf16* Os = reinterpret_cast<bf16*>(Cs + BM * LDC);
  bf16* Fs = Os + BM * LDO;
  float* Ts = reinterpret_cast<float*>(Fs + BN * LDF);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;   // rows warp_m*16 .. +15
  const int warp_n = warp >> 2;  // out cols warp_n*32 .. +31; key cols warp_n*64 .. +63
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;

  // resident input rows: the virtual concat [p0 | p1 | p2 | pc], 16 B at a time
  const int units = Kmm / 8;
  for (int u = tid; u < BM * units; u += blockDim.x) {
    const int r = u / units;
    const int col = (u - r * units) * 8;
    const long long row = m0 + r;
    bf16* dst = As + r * LDA + col;
    if (row >= M) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const bf16* src;
    if (col < K0) src = p0 + row * K0 + col;
    else if (col < 2 * K0) src = p1 + row * K0 + (col - K0);
    else if (col < 3 * K0) src = p2 + row * K0 + (col - 2 * K0);
    else src = pc + row * Kc + (col - 3 * K0);
    cp_async16(dst, src);
  }
  for (int u = tid; u < BM * 3; u += blockDim.x) {
    const long long row = m0 + u / 3;
    Ts[u] = row < M ? __bfloat162float(pt[row * 3 + (u % 3)]) : 0.0f;
  }
  cp_async_commit();

  const int KT = Kmm / BK;
  const int NC = N / BN;
  const int n_tiles = NC * KT;
  auto issue_w = [&](int it) {
    const int nc = it / KT, kt = it - (it / KT) * KT;
    const int r = tid >> 3, c = (tid & 7) * 8;  // 32 rows x 8 vectors = 256 threads
    cp_async16(Ws + (it & 1) * BK * LDW + r * LDW + c,
               Wt + static_cast<long long>(kt * BK + r) * N + nc * BN + c);
    cp_async_commit();
  };
  issue_w(0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> kacc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(kacc[f], 0.0f);

  for (int nc = 0; nc < NC; ++nc) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
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
        wmma::load_matrix_sync(a, As + (warp_m * 16) * LDA + kt * BK + kk * 16, LDA);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wbuf + (kk * 16) * LDW + warp_n * 32 + f * 16, LDW);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
      __syncthreads();
    }

    // epilogue: stage the f32 chunk, add the tanh FMAs and bias, relu, round
#pragma unroll
    for (int f = 0; f < 2; ++f)
      wmma::store_matrix_sync(Cs + (warp_m * 16) * LDC + warp_n * 32 + f * 16, acc[f], LDC,
                              wmma::mem_row_major);
    for (int u = tid; u < BN * (KNK / 8); u += blockDim.x) {
      const int r = u / (KNK / 8), c = (u % (KNK / 8)) * 8;
      *reinterpret_cast<uint4*>(Fs + r * LDF + c) =
          *reinterpret_cast<const uint4*>(fk + static_cast<long long>(nc * BN + r) * KNK + c);
    }
    __syncthreads();
    for (int u = tid; u < BM * (BN / 8); u += blockDim.x) {
      const int r = u / (BN / 8), c = (u % (BN / 8)) * 8;
      const long long row = m0 + r;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = nc * BN + c + e;
        float a = Cs[r * LDC + c + e];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          a = __fadd_rn(a, __fmul_rn(Ts[r * 3 + j],
                                     __bfloat162float(Wt[static_cast<long long>(Kmm + j) * N + col])));
        a = __fadd_rn(a, bias[col]);
        v[e] = fmaxf(a, 0.0f);
      }
      store16(Os + r * LDO + c, v);
      if (row < M) store16(out + row * N + nc * BN + c, v);
    }
    __syncthreads();

    // key head from the rounded chunk: kacc += Os (64 x 64) @ Fs (64 x 128)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Os + (warp_m * 16) * LDO + kk * 16, LDO);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Fs + (kk * 16) * LDF + warp_n * 64 + f * 16, LDF);
        wmma::mma_sync(kacc[f], a, b, kacc[f]);
      }
    }
    __syncthreads();
  }

  // stage the key accumulator in the (now free) input-row region and store
  float* Ks = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(Ks + (warp_m * 16) * LDK + warp_n * 64 + f * 16, kacc[f], LDK,
                            wmma::mem_row_major);
  __syncthreads();
  for (int u = tid; u < BM * (KNK / 8); u += blockDim.x) {
    const int r = u / (KNK / 8), c = (u % (KNK / 8)) * 8;
    const long long row = m0 + r;
    if (row >= M) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Ks[r * LDK + c + e];
    store16(kout + row * KNK + c, v);
  }
}

// ------------------------------------------------------------------- f32 --
constexpr int FBM = 32, FBN = 64, FBK = 32, LDFO = FBN + 4;

__host__ __device__ inline size_t f32_smem_bytes(int Kmm) {
  return (static_cast<size_t>(FBM) * (Kmm + 4) + FBK * FBN + FBM * LDFO + FBN * KNK + FBM * 3) * 4;
}

__global__ void __launch_bounds__(256)
split_dense_relu_f32(const float* __restrict__ p0, const float* __restrict__ p1,
                     const float* __restrict__ p2, const float* __restrict__ pc,
                     const float* __restrict__ pt, const float* __restrict__ Wt,
                     const float* __restrict__ bias, const float* __restrict__ fk,
                     float* __restrict__ out, float* __restrict__ kout, long long M, int K0,
                     int Kc, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Kmm = 3 * K0 + Kc;
  const int LDA = Kmm + 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = As + FBM * LDA;
  float* Os = Ws + FBK * FBN;
  float* Fs = Os + FBM * LDFO;
  float* Ts = Fs + FBN * KNK;

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * FBM;
  const int units = Kmm / 4;
  for (int u = tid; u < FBM * units; u += blockDim.x) {
    const int r = u / units;
    const int col = (u - r * units) * 4;
    const long long row = m0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < M) {
      const float* src;
      if (col < K0) src = p0 + row * K0 + col;
      else if (col < 2 * K0) src = p1 + row * K0 + (col - K0);
      else if (col < 3 * K0) src = p2 + row * K0 + (col - 2 * K0);
      else src = pc + row * Kc + (col - 3 * K0);
      val = *reinterpret_cast<const float4*>(src);
    }
    *reinterpret_cast<float4*>(As + r * LDA + col) = val;
  }
  for (int u = tid; u < FBM * 3; u += blockDim.x) {
    const long long row = m0 + u / 3;
    Ts[u] = row < M ? pt[row * 3 + (u % 3)] : 0.0f;
  }

  const int tx = tid & 15, ty = tid >> 4;  // out: rows ty*2 + i, cols tx*4 + j
  const int kx = tid & 31, ky = tid >> 5;  // key: rows ky*4 + i, cols kx*4 + j
  float kacc[4][4] = {};
  for (int nc = 0; nc < N / FBN; ++nc) {
    float acc[2][4] = {};
    for (int kt = 0; kt < Kmm / FBK; ++kt) {
      __syncthreads();
      for (int u = tid; u < FBK * FBN / 4; u += blockDim.x) {
        const int r = u / (FBN / 4), c = (u % (FBN / 4)) * 4;
        *reinterpret_cast<float4*>(Ws + r * FBN + c) = *reinterpret_cast<const float4*>(
            Wt + static_cast<long long>(kt * FBK + r) * N + nc * FBN + c);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < FBK; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(Ws + kk * FBN + tx * 4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a = As[(ty * 2 + i) * LDA + kt * FBK + kk];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
      const long long row = m0 + r;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nc * FBN + tx * 4 + j;
        float a = acc[i][j];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          a = __fadd_rn(a, __fmul_rn(Ts[r * 3 + q], Wt[static_cast<long long>(Kmm + q) * N + col]));
        v[j] = fmaxf(__fadd_rn(a, bias[col]), 0.0f);
      }
      store16(Os + r * LDFO + tx * 4, v);
      if (row < M) store16(out + row * N + nc * FBN + tx * 4, v);
    }
    for (int u = tid; u < FBN * KNK / 4; u += blockDim.x) {
      const int r = u / (KNK / 4), c = (u % (KNK / 4)) * 4;
      *reinterpret_cast<float4*>(Fs + r * KNK + c) =
          *reinterpret_cast<const float4*>(fk + static_cast<long long>(nc * FBN + r) * KNK + c);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < FBN; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(Fs + c * KNK + kx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = Os[(ky * 4 + i) * LDFO + c];
        kacc[i][0] = fmaf(a, b.x, kacc[i][0]);
        kacc[i][1] = fmaf(a, b.y, kacc[i][1]);
        kacc[i][2] = fmaf(a, b.z, kacc[i][2]);
        kacc[i][3] = fmaf(a, b.w, kacc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ky * 4 + i;
    if (row < M) store16(kout + row * KNK + kx * 4, kacc[i]);
  }
}

}  // namespace coponerf

extern "C" int k2_split_dense_relu(const void* p0, const void* p1, const void* p2,
                                   const void* pc, const void* pt, const void* W,
                                   const void* bias, const void* fk, void* out, void* k,
                                   long long M, int K0, int Kc, int N, int NK, int dtype,
                                   void* stream) {
  using namespace coponerf;
  const int Kmm = 3 * K0 + Kc;
  if (NK != KNK || N % 64 != 0 || Kmm % 32 != 0 || K0 % 8 != 0 || Kc % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const size_t bytes = bf16_smem_bytes(Kmm);
    cudaError_t e = cudaFuncSetAttribute(split_dense_relu_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long blocks = (M + BM - 1) / BM;
    split_dense_relu_bf16<<<static_cast<unsigned>(blocks), 256, bytes, s>>>(
        static_cast<const bf16*>(p0), static_cast<const bf16*>(p1), static_cast<const bf16*>(p2),
        static_cast<const bf16*>(pc), static_cast<const bf16*>(pt), static_cast<const bf16*>(W),
        static_cast<const float*>(bias), static_cast<const bf16*>(fk), static_cast<bf16*>(out),
        static_cast<bf16*>(k), M, K0, Kc, N);
  } else {
    const size_t bytes = f32_smem_bytes(Kmm);
    cudaError_t e = cudaFuncSetAttribute(split_dense_relu_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long blocks = (M + FBM - 1) / FBM;
    split_dense_relu_f32<<<static_cast<unsigned>(blocks), 256, bytes, s>>>(
        static_cast<const float*>(p0), static_cast<const float*>(p1),
        static_cast<const float*>(p2), static_cast<const float*>(pc),
        static_cast<const float*>(pt), static_cast<const float*>(W),
        static_cast<const float*>(bias), static_cast<const float*>(fk),
        static_cast<float*>(out), static_cast<float*>(k), M, K0, Kc, N);
  }
  return static_cast<int>(cudaGetLastError());
}
