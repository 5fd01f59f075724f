// K1 and K8: bilinear sampling of flat latent tables at [-1, 1] (x, y)
// points, and the corner-id gather.
//
// k1_multilevel_sample samples 1 to 4 levels at one shared grid in one
// launch.  With one level it is K1, replacing
// coponerf_tpu/ops/pallas/bilinear_sample.py:onehot_matmul_sample_xy (the
// banded one-hot selection matmul, reached through grid_sample_onehot);
// with the render's levels it is K8a, replacing
// coponerf_tpu/ops/pallas/experimental/multilevel_sample.py:multilevel_banded_sample
// (the three small levels, each table resident in VMEM, walked in row
// bands); with one large level and f32 output it is K8b, replacing
// experimental/windowed_sample.py:onehot_window_sample_xy (row-window DMAs).
//
// What bounds it on the H100: bytes.  Each point reads 4 corner rows of C
// channels and writes one row; there is no reuse to feed a tensor core.  The
// TPU built a one-hot matrix because its gather engine was slow; Hopper's
// load path gathers 16-byte vectors directly, so this is a direct 4-corner
// gather, corner weights in f32 from the same pixel coordinates as the
// plain version (ops/grid_sample.py), f32 blend.  The tables (~22 MiB for
// the render's four levels of a view pair, up to 25 MB for the training
// level) stay in the 50 MB L2, so the TPU's bands, VMEM residency and DMA
// windows have no counterpart here and no table size limit applies.
//
// What held the gather back on this card was latency, not bytes: timed
// with every point on one spot, so that every corner read hits L1, the
// one-thread-a-vector kernel ran as long as with the real points, twice the
// time of writing its output alone (PERF.md).  Each thread's chain (grid
// load from memory, corners, four corner loads, blend, one 16-byte store)
// was too long for the 16 bytes it wrote.  So a block takes a tile of 64
// consecutive points of one row and one level in two steps:
//   1. one thread a point loads its grid entry (one coalesced read for the
//      tile) and computes its corners once, into shared memory: the four
//      element offsets of the in-image corner rows and the four weights;
//   2. the tile's (point, 16-byte channel vector) items, point-major, go to
//      the block's 256 threads in turns (8 each at C 256, 2 at C 64); an
//      item reads its point's corners from shared memory, loads and blends
//      the four corner vectors, and stores 16 bytes, so at each turn the
//      block writes one contiguous run of the output.
// The output goes out with streaming stores (evict first), so it does not
// push the tables' lines out of L2.  Probes timed in turns on the card
// (PERF.md) chose one item at a time over two or four in flight (fewer
// registers, more threads resident) and 64 points a tile over 128 and 256.
//
// The launch is a grid of (blocks over the levels, batch rows).  Along x
// the blocks are level-major: each level's share is laid out as a one-level
// launch (one tile a block), and a block finds its level from the levels'
// first-block offsets, so a block reads one table.  Spreading a point's
// vectors of all levels over consecutive threads made every block read all
// four tables and ran slower (PERF.md).  The batch row is blockIdx.y, so an
// item's point and vector come from 32-bit arithmetic: a shift where C / 8
// is a power of two (every level the model samples), else one 32-bit
// division.
//
// Second entry, k1_corner_sample: the same gather from precomputed corner
// ids and weights (B, P, 4), replacing
// coponerf_tpu/ops/pallas/bilinear_sample.py:onehot_matmul_sample (the
// one-hot matmul over corner ids, reached through onehot_sample_diff).
// Corners with idx < 0 or idx >= HW are skipped, as the one-hot matrix
// matches no table row for them; weights stay f32 (the TPU rounded them to
// bf16).  Output bf16 or f32.
//
// Padding: border clamps the coordinates into [0, size-1-1e-5]; zeros
// scrubs NaN/Inf to the +-3e4 clip, shifts by 2 (the JAX zero-ring
// convention, so weights are bit-identical) and reads a corner only when
// 0 <= xi < W and 0 <= yi < H (all four bounds).

#include "common.cuh"

namespace coponerf {

using bf16 = __nv_bfloat16;

// The border clamp of a level of ``size`` texels: size - 1 - 1e-5 in double,
// rounded to f32, as the plain version's clamp.
inline float border_max(int size) { return static_cast<float>(static_cast<double>(size) - 1.0 - 1e-5); }

// Top-left corner and the four corner weights of one [-1, 1] point on an
// H x W level (corners in the order (y, x) = (0, 0), (0, 1), (1, 0), (1, 1)).
struct Bilinear {
  int x0, y0;
  float w[4];
};

// xmax, ymax: the border clamp of the level, border_max(W) and border_max(H)

__device__ __forceinline__ Bilinear bilinear_corners(float gx, float gy, int H, int W, float xmax, float ymax,
                                                     int zeros_mode) {
  // _unnormalize (align_corners=False), without FMA contraction
  float x = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.0f), static_cast<float>(W)), 1.0f), 0.5f);
  float y = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.0f), static_cast<float>(H)), 1.0f), 0.5f);
  int shift = 0;
  if (zeros_mode) {
    const float clip = 3.0e4f;
    x = isnan(x) ? -clip : fminf(fmaxf(x, -clip), clip);
    y = isnan(y) ? -clip : fminf(fmaxf(y, -clip), clip);
    x = __fadd_rn(x, 2.0f);
    y = __fadd_rn(y, 2.0f);
    shift = 2;
  } else {
    x = fminf(fmaxf(x, 0.0f), xmax);
    y = fminf(fmaxf(y, 0.0f), ymax);
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f);
  const float wy = __fsub_rn(y, y0f);
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);
  return {static_cast<int>(x0f) - shift, static_cast<int>(y0f) - shift,
          {__fmul_rn(ux, uy), __fmul_rn(wx, uy), __fmul_rn(ux, wy), __fmul_rn(wx, wy)}};
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) { store16(p, v); }

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  const float a[4] = {v[0], v[1], v[2], v[3]};
  const float b[4] = {v[4], v[5], v[6], v[7]};
  store16(p, a);
  store16(p + 4, b);
}

template <typename OutT>
__global__ void corner_sample_kernel(const bf16* __restrict__ table, const int* __restrict__ idx,
                                     const float* __restrict__ w, OutT* __restrict__ out, int B,
                                     int HW, int C, long long P) {
  constexpr int VEC = Vec16<bf16>::N;
  const int nvec = C / VEC;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(B) * P * nvec) return;
  const long long bp = tid / nvec;
  const int v = static_cast<int>(tid - bp * nvec);
  const long long b = bp / P;
  const int4 id4 = *reinterpret_cast<const int4*>(idx + 4 * bp);
  const float4 w4 = *reinterpret_cast<const float4*>(w + 4 * bp);
  const int ids[4] = {id4.x, id4.y, id4.z, id4.w};
  const float ws[4] = {w4.x, w4.y, w4.z, w4.w};

  const bf16* base = table + b * HW * C + static_cast<long long>(v) * VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (ids[c] < 0 || ids[c] >= HW) continue;
    float val[VEC];
    load16(base + static_cast<long long>(ids[c]) * C, val);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(val[e], ws[c]));
  }
  store8(out + bp * C + static_cast<long long>(v) * VEC, acc);
}

constexpr int kMaxLevels = 4;

constexpr int kThreads = 256;
constexpr int kTile = 64;  // consecutive points a block takes (8 items a thread at C 256)

struct Level {
  const bf16* table;  // (B, H, W, C)
  void* out;          // (B, P, C)
  int H, W, C;
  float xmax, ymax;   // border_max(W), border_max(H)
  int shift;          // log2(C / 8) where C / 8 is a power of two, else -1
  unsigned block0;    // the level's first block along x
};

struct Levels {
  Level l[kMaxLevels];  // slots past the last level start past the last block
};

// a point's corners: element offsets of the in-image corner rows in the
// row's table (-1: outside), and the four weights
struct Corners {
  int4 off;
  float4 w;
};

// streaming (evict-first) 16-byte stores of one 8-channel vector
__device__ __forceinline__ void store8_cs(bf16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), q);
}

__device__ __forceinline__ void store8_cs(float* p, const float (&v)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

// one (point, vector) item: the in-image corner vectors at src + off,
// blended in f32 in corner order, stored to out
template <typename OutT>
__device__ __forceinline__ void sample_item(OutT* out, const bf16* src, const Corners& cn) {
  const int o[4] = {cn.off.x, cn.off.y, cn.off.z, cn.off.w};
  const float w[4] = {cn.w.x, cn.w.y, cn.w.z, cn.w.w};
  uint4 val[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    val[c] = o[c] >= 0 ? __ldg(reinterpret_cast<const uint4*>(src + o[c])) : make_uint4(0u, 0u, 0u, 0u);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (o[c] < 0) continue;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&val[c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] = __fadd_rn(acc[2 * i], __fmul_rn(f.x, w[c]));
      acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __fmul_rn(f.y, w[c]));
    }
  }
  store8_cs(out, acc);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) multilevel_sample_kernel(const Levels lv, const float* __restrict__ grid,
                                                                     unsigned P, int zeros_mode) {
  __shared__ Corners s_cn[kTile];
  // the block's level, picked with constant indices so the struct stays
  // in parameter space
  Level L = lv.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (blockIdx.x >= lv.l[i].block0) L = lv.l[i];
  }
  const unsigned p0 = (blockIdx.x - L.block0) * kTile;
  const unsigned np = P - p0 < kTile ? P - p0 : kTile;
  const long long b = blockIdx.y;

  // 1. the tile's corners, one thread a point
  if (threadIdx.x < np) {
    const float2 gp = __ldg(reinterpret_cast<const float2*>(grid) + (b * P + p0 + threadIdx.x));
    const Bilinear q = bilinear_corners(gp.x, gp.y, L.H, L.W, L.xmax, L.ymax, zeros_mode);
    int o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int xi = q.x0 + (c & 1);
      const int yi = q.y0 + (c >> 1);
      o[c] = xi < 0 || xi >= L.W || yi < 0 || yi >= L.H ? -1 : (yi * L.W + xi) * L.C;
    }
    s_cn[threadIdx.x] = {make_int4(o[0], o[1], o[2], o[3]), make_float4(q.w[0], q.w[1], q.w[2], q.w[3])};
  }
  __syncthreads();

  // 2. the tile's (point, vector) items, point-major, in turns
  const bf16* base = L.table + b * L.H * L.W * L.C;
  OutT* out = static_cast<OutT*>(L.out) + (b * P + p0) * L.C;
  const unsigned nvec = static_cast<unsigned>(L.C) / Vec16<bf16>::N;
  const unsigned items = np * nvec;
  for (unsigned it = threadIdx.x; it < items; it += kThreads) {
    unsigned p, v;
    if (L.shift >= 0) {
      p = it >> L.shift;
      v = it & ((1u << L.shift) - 1u);
    } else {
      p = it / nvec;
      v = it - p * nvec;
    }
    sample_item(out + static_cast<size_t>(it) * Vec16<bf16>::N, base + v * Vec16<bf16>::N, s_cn[p]);
  }
}

}  // namespace coponerf

// table (B, HW, C) bf16, idx (B, P, 4) i32, w (B, P, 4) f32,
// out (B, P, C) f32 (out_f32 = 1) or bf16
extern "C" int k1_corner_sample(const void* table, const void* idx, const void* w, void* out, int B,
                                int HW, int C, long long P, int out_f32, void* stream) {
  using coponerf::bf16;
  const long long total = static_cast<long long>(B) * P * (C / coponerf::Vec16<bf16>::N);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  auto s = static_cast<cudaStream_t>(stream);
  const bf16* t = static_cast<const bf16*>(table);
  const int* i = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  if (out_f32) {
    coponerf::corner_sample_kernel<float><<<blocks, threads, 0, s>>>(t, i, wt, static_cast<float*>(out),
                                                                      B, HW, C, P);
  } else {
    coponerf::corner_sample_kernel<bf16><<<blocks, threads, 0, s>>>(t, i, wt, static_cast<bf16*>(out),
                                                                     B, HW, C, P);
  }
  return static_cast<int>(cudaGetLastError());
}

// grid (B, P, 2) f32, 8-byte aligned; n_levels tables (B, H_l, W_l, C_l)
// bf16 (t1-t3 and o1-o3 past n_levels are ignored); out_l (B, P, C_l) f32
// (out_f32 = 1) or bf16.  Limits of the 32-bit indexing: B <= 65535,
// P * C_l / 8 and H_l * W_l * C_l below 2^31.
extern "C" int k1_multilevel_sample(const void* grid, int n_levels, const void* t0, const void* t1,
                                    const void* t2, const void* t3, void* o0, void* o1, void* o2,
                                    void* o3, int H0, int W0, int C0, int H1, int W1, int C1, int H2,
                                    int W2, int C2, int H3, int W3, int C3, int B, long long P,
                                    int zeros_mode, int out_f32, void* stream) {
  using coponerf::bf16;
  constexpr long long kLimit = 1LL << 31;
  if (n_levels < 1 || n_levels > coponerf::kMaxLevels || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || P == 0) return 0;
  const void* tabs[4] = {t0, t1, t2, t3};
  void* outs[4] = {o0, o1, o2, o3};
  const int dims[4][3] = {{H0, W0, C0}, {H1, W1, C1}, {H2, W2, C2}, {H3, W3, C3}};
  using coponerf::kThreads;
  coponerf::Levels lv{};
  long long blocks = 0;
  for (int i = 0; i < coponerf::kMaxLevels; ++i) {
    const int k = i < n_levels ? i : 0;  // unused slots repeat level 0 and start past the last block
    const int nvec = dims[k][2] / coponerf::Vec16<bf16>::N;
    int shift = -1;
    for (int e = 0; e < 31; ++e) {
      if ((1 << e) == nvec) shift = e;
    }
    lv.l[i] = {static_cast<const bf16*>(tabs[k]), outs[k], dims[k][0], dims[k][1], dims[k][2],
               coponerf::border_max(dims[k][1]), coponerf::border_max(dims[k][0]), shift,
               static_cast<unsigned>(blocks)};
    if (i < n_levels) {
      if (P * nvec >= kLimit || static_cast<long long>(dims[i][0]) * dims[i][1] * dims[i][2] >= kLimit) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      blocks += (P + coponerf::kTile - 1) / coponerf::kTile;
    }
  }
  if (blocks >= kLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  const dim3 nb(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  const unsigned p32 = static_cast<unsigned>(P);
  if (out_f32) {
    coponerf::multilevel_sample_kernel<float><<<nb, kThreads, 0, s>>>(lv, g, p32, zeros_mode);
  } else {
    coponerf::multilevel_sample_kernel<bf16><<<nb, kThreads, 0, s>>>(lv, g, p32, zeros_mode);
  }
  return static_cast<int>(cudaGetLastError());
}
