// K4: the sampler's backward, a scatter-add of point cotangents into the
// table gradient.
//
//   dtable[b, idx[b,p,c], :] += w[b,p,c] * g[b,p,:]   over the 4 corners c
//
// Replaces coponerf_tpu/ops/pallas/bilinear_sample.py:onehot_transpose_matmul
// (the dense one-hot transpose matmul M^T @ g, built per (hw-block, p-block)
// in VMEM and accumulated over point blocks on the MXU).  The TPU had no
// fast scatter, so it multiplied by a mostly-zero matrix; this is a direct
// scatter into an f32 output the wrapper zeroes.  Corners with idx < 0,
// idx >= HW or w == 0 are skipped.
//
// What bounds it on the H100: bytes (g read once, the table gradient
// written once), if the adds were free.  They are not: B 12 x P 12288 x 4
// corners x C 256 is ~151 M f32 adds (~600 MB) a call, and the L2 takes
// RED traffic at a byte rate (float4 REDs cost what scalar ones do), so a
// kernel that sends one RED a lane per corner spends its time there.
// This kernel cuts the RED traffic by adding each corner's contributions
// up in registers first, which needs the points that share corners to be
// neighbours:
//
// - Order (order_kernel, one block a row): a counting sort of the row's
//   points by cell (the first corner's id; tables above 4096 cells are
//   binned 2^k cells at a time), into a permutation in device scratch.
//   Training's points are ray-major, but at the 64^2 level a ray's
//   consecutive samples rarely share a cell, so merging along the given
//   order saved little there.
// - Merge (merge_kernel): a warp walks 64 consecutive points of that
//   order, lanes over 256 channels (4 consecutive a lane, twice), and
//   holds the current cell's four corner sums in registers: a point of the
//   same cell adds into them, a point one cell over keeps the two shared
//   corners' sums, anything else flushes.  Ids and weights are the same in
//   every lane, so this control flow is warp-uniform.  A warp's next 8
//   points (ids, weights, cotangents) come into its shared-memory buffer
//   by cp.async while it merges the 8 before.
// - Flush: a corner sum goes to the output as float4 REDs
//   (red.global.add.v4.f32, sm_90), a lane's four channels in one
//   instruction.
// Indices are 32-bit: the row comes from blockIdx.y, its base pointers
// from one 64-bit multiply.
//
// The f32 sums are taken in the order the atomics land (and the sort puts
// the points of a cell in the order its atomics give), which varies from
// run to run: the result's low bits are not reproducible, and the kernel
// is held to its plain version (ops/bilinear_sample.py, index_add_ in f32)
// with a tolerance.

#include "common.cuh"

namespace coponerf {
namespace k4 {

using bf16 = __nv_bfloat16;

constexpr int kOrderThreads = 1024;
constexpr int kMaxBins = 4096;    // cells the sort tells apart
constexpr int kWarps = 8;
constexpr int kRun = 64;          // points of the order a warp walks
constexpr int kStage = 8;         // points a warp stages at once; two stages in flight
constexpr int kSpan = 256;        // channels a warp holds

// a warp's staging buffer: two stages of kStage points, each the points'
// ids and weights (32 B a point), then their cotangents (span B a point)
__host__ __device__ constexpr int stage_bytes(int span) { return kStage * (32 + span); }

__device__ __forceinline__ int cell_bin(int id, int HW, int shift) { return min(max(id, 0), HW - 1) >> shift; }

// perm[b, :] = row b's point indices sorted by cell_bin of their first corner
__global__ void __launch_bounds__(kOrderThreads)
order_kernel(const int* __restrict__ idx, int* __restrict__ perm, int P, int HW, int shift, int bins) {
  __shared__ int hist[kMaxBins];
  __shared__ int warp_sums[kOrderThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* id = idx + static_cast<size_t>(blockIdx.x) * P * 4;
  int* out = perm + static_cast<size_t>(blockIdx.x) * P;
  for (int i = tid; i < bins; i += kOrderThreads) hist[i] = 0;
  __syncthreads();
  for (int p = tid; p < P; p += kOrderThreads) atomicAdd(&hist[cell_bin(__ldg(id + 4 * p), HW, shift)], 1);
  __syncthreads();
  // exclusive scan of the counts: 4 consecutive bins a thread
  int v[4], sum = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * tid + k;
    v[k] = i < bins ? hist[i] : 0;
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = warp_sums[lane], y = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    warp_sums[lane] = y - x;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * tid + k;
    if (i < bins) hist[i] = run;
    run += v[k];
  }
  __syncthreads();
  for (int p = tid; p < P; p += kOrderThreads) out[atomicAdd(&hist[cell_bin(__ldg(id + 4 * p), HW, shift)], 1)] = p;
}

// four consecutive values of T in shared memory, as f32
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x; v[1] = a.y; v[2] = c.x; v[3] = c.y;
  }
}

// The corner sums of the current cell a warp holds in registers: the four
// corner positions (-1: none, never flushed) and NV values a lane each.
// A point of the same cell adds into them.  A point one cell to the side
// (the corner order is (x, y), (x+1, y), (x, y+1), (x+1, y+1)) keeps the
// two shared corners' sums and flushes the other two; any other point
// flushes all four.  Only the merging depends on that order.
template <int NV>
struct Held {
  int key[4];
  float acc[4][NV];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      key[c] = -1;
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[c][i] = 0.f;
    }
  }

  template <typename Flush>
  __device__ __forceinline__ void flush_one(int c, Flush& flush) {
    if (key[c] >= 0) flush(key[c], acc[c]);
  }

  // corner c's sum becomes corner d's (d < 0: zero)
  __device__ __forceinline__ void move(int c, int d) {
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[c][i] = d < 0 ? 0.f : acc[d < 0 ? 0 : d][i];
  }

  template <typename Flush>
  __device__ __forceinline__ void drain(Flush& flush) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      flush_one(c, flush);
      move(c, -1);
    }
  }

  // add one point: ids n (-1 for a skipped corner), weights wt, the lane's
  // cotangent values gv
  template <typename Flush>
  __device__ __forceinline__ void add(const int (&n)[4], const float (&wt)[4], const float (&gv)[NV],
                                      Flush& flush) {
    if (n[0] != key[0] || n[1] != key[1] || n[2] != key[2] || n[3] != key[3]) {
      if (n[0] == key[1] && n[2] == key[3]) {         // one cell right: the old right column stays
        flush_one(0, flush); flush_one(2, flush);
        move(0, 1); move(2, 3); move(1, -1); move(3, -1);
      } else if (n[1] == key[0] && n[3] == key[2]) {  // one cell left
        flush_one(1, flush); flush_one(3, flush);
        move(1, 0); move(3, 2); move(0, -1); move(2, -1);
      } else if (n[0] == key[2] && n[1] == key[3]) {  // one cell down: the old bottom row stays
        flush_one(0, flush); flush_one(1, flush);
        move(0, 2); move(1, 3); move(2, -1); move(3, -1);
      } else if (n[2] == key[0] && n[3] == key[1]) {  // one cell up
        flush_one(2, flush); flush_one(3, flush);
        move(2, 0); move(3, 1); move(0, -1); move(1, -1);
      } else {
        drain(flush);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) key[c] = n[c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[c][i] = fmaf(wt[c], gv[i], acc[c][i]);
    }
  }
};

// One warp per (row, run of kRun points of the order, block of 256
// channels); lane l owns channels cb + 4l + 128h (h = 0, 1).  The warp
// stages its points kStage at a time into its shared-memory buffer by
// cp.async, one stage ahead of the merge.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
merge_kernel(const T* __restrict__ g, const int* __restrict__ idx, const float* __restrict__ w,
             const int* __restrict__ perm, float* __restrict__ out, int P, int HW, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = (blockIdx.x * kWarps + warp) * kRun;
  if (p0 >= P) return;
  const int p1 = min(P, p0 + kRun);
  const int b = blockIdx.y, cb = blockIdx.z * kSpan, c0 = cb + 4 * lane;
  const int span = min(kSpan, C - cb) * static_cast<int>(sizeof(T));  // bytes a point, a multiple of 16
  const unsigned on = (c0 < C ? 1u : 0u) | (c0 + 128 < C ? 2u : 0u);
  const size_t row = static_cast<size_t>(b) * P;
  const int* rid = idx + 4 * row;
  const float* rw = w + 4 * row;
  const T* rg = g + row * C + cb;
  float* o = out + static_cast<size_t>(b) * HW * C + c0;
  unsigned char* buf = smem + warp * 2 * stage_bytes(kSpan * sizeof(T));
  const int sb = stage_bytes(span), cpp = span / 16;
  // the run's point indices, two a lane: point i of the run is held by lane i % 32
  static_assert(kRun == 64, "two point indices a lane");
  int pt[2];
#pragma unroll
  for (int h = 0; h < kRun / 32; ++h) pt[h] = p0 + 32 * h + lane < p1 ? __ldg(perm + row + p0 + 32 * h + lane) : 0;

  auto issue = [&](int i0, int stage) {  // run points i0 .. i0 + kStage - 1
    unsigned char* st = buf + stage * sb;
    const int m = min(kStage, p1 - p0 - i0);
    for (int q = 0; q < m; ++q) {
      const int i = i0 + q;
      const int p = __shfl_sync(0xffffffffu, (i >> 5) ? pt[1] : pt[0], i & 31);
      if (lane < 2) cp_async16(st + q * 32 + lane * 16, lane ? static_cast<const void*>(rw + 4 * p)
                                                             : static_cast<const void*>(rid + 4 * p));
      const unsigned char* src = reinterpret_cast<const unsigned char*>(rg + static_cast<size_t>(p) * C);
      for (int c = lane; c < cpp; c += 32) cp_async16(st + kStage * 32 + q * span + c * 16, src + c * 16);
    }
    cp_async_commit();
  };
  auto flush = [&](int key, const float(&acc)[8]) {
    float* t = o + static_cast<size_t>(key) * C;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (on >> h & 1u)
        atomicAdd(reinterpret_cast<float4*>(t + 128 * h),
                  make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2], acc[4 * h + 3]));
  };

  Held<8> held;
  held.init();
  int stage = 0;
  issue(0, 0);
  for (int i0 = 0; i0 < p1 - p0; i0 += kStage) {
    __syncwarp();  // every lane is done with the stage the next issue overwrites
    if (i0 + kStage < p1 - p0) issue(i0 + kStage, stage ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const unsigned char* st = buf + stage * sb;
    const int m = min(kStage, p1 - p0 - i0);
    for (int q = 0; q < m; ++q) {
      const int4 id = *reinterpret_cast<const int4*>(st + q * 32);
      const float4 w4 = *reinterpret_cast<const float4*>(st + q * 32 + 16);
      const int ids[4] = {id.x, id.y, id.z, id.w};
      const float wt[4] = {w4.x, w4.y, w4.z, w4.w};
      int n[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) n[c] = (ids[c] >= 0 && ids[c] < HW && wt[c] != 0.f) ? ids[c] : -1;
      float gv[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (on >> h & 1u) load4<T>(st + kStage * 32 + q * span + (4 * lane + 128 * h) * sizeof(T), v);
#pragma unroll
        for (int e = 0; e < 4; ++e) gv[4 * h + e] = v[e];
      }
      held.add(n, wt, gv, flush);
    }
    stage ^= 1;
  }
  held.drain(flush);
}

template <typename T>
int launch(const T* g, const int* idx, const float* w, int* perm, float* out, int B, int P, int HW, int C,
           cudaStream_t s) {
  if (C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int shift = 0;
  while (((HW - 1) >> shift) >= kMaxBins) ++shift;
  order_kernel<<<B, kOrderThreads, 0, s>>>(idx, perm, P, HW, shift, ((HW - 1) >> shift) + 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = static_cast<size_t>(kWarps) * 2 * stage_bytes(kSpan * sizeof(T));
  e = cudaFuncSetAttribute(merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((P + kWarps * kRun - 1) / (kWarps * kRun), B, (C + kSpan - 1) / kSpan);
  merge_kernel<T><<<grid, kWarps * 32, bytes, s>>>(g, idx, w, perm, out, P, HW, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k4
}  // namespace coponerf

// g (B, P, C) f32 or bf16 (C a multiple of 8, 16-byte aligned), idx
// (B, P, 4) i32, w (B, P, 4) f32, perm (B, P) i32 scratch, out (B, HW, C)
// f32 zeroed by the caller
extern "C" int k4_transpose_sample(const void* g, const void* idx, const void* w, void* perm, void* out, int B,
                                   int P, int HW, int C, int g_dtype, void* stream) {
  using namespace coponerf;
  if (static_cast<long long>(B) * P == 0 || C == 0 || HW <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  int* pm = static_cast<int*>(perm);
  float* o = static_cast<float*>(out);
  if (g_dtype == kBF16) return k4::launch(static_cast<const k4::bf16*>(g), i, wt, pm, o, B, P, HW, C, s);
  return k4::launch(static_cast<const float*>(g), i, wt, pm, o, B, P, HW, C, s);
}
