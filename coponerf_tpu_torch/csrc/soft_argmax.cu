// K5: the fused dual-axis soft-argmax over a flat correlation volume c
// (B, Q, S) f32, forward statistics and backward.
//
// Replaces coponerf_tpu/ops/pallas/soft_argmax.py: _stats (kernel
// _fwd_kernel) and _bwd (kernel _bwd_kernel).  With x/y the row-major grid
// coordinates in [-1, 1] of the s (xs, ys) and q (xq, yq) tokens:
//
//   row q:    m1 = max_s c,  z1 = sum_s e1,  sum_s e1*xs,  sum_s e1*ys,
//             e1 = exp((c[q,s] - m1) / beta)
//   column s: m2 = max_q c,  z2 = sum_q e2,  sum_q e2*xq,  sum_q e2*yq,
//             e2 = exp((c[q,s] - m2) / beta)
//   dc[q,s] = e1/z1 * ((xs-gx1)*dgx1 + (ys-gy1)*dgy1) / beta
//           + e2/z2 * ((xq-gx2)*dgx2 + (yq-gy2)*dgy2) / beta
//
// What bounds it on the H100: bytes.  The forward reads the volume once
// (402.7 MB at B 6, Q = S = 4096: 0.120 ms at 3.35 TB/s) for about 16
// operations an element; the backward reads it and writes dc (0.240 ms).
//
// Forward design: one launch that streams the volume once.  Blocks on
// Hopper run in no order, so the TPU kernel's sequential grid axis (which
// carried the column statistics from q-block to q-block) becomes a loop
// inside a block, and what crosses blocks merges inside the launch.  The
// statistics merge associatively: m = max(ma, mb),
// z = za*e^((ma-m)/beta) + zb*e^((mb-m)/beta), the same rescale for the
// coordinate sums.
//  - Work units: a unit is one batch element's strip of 256 columns over a
//    band of rows.  The host picks the band height (whole 32-row chunks)
//    that spreads the units most evenly over one persistent block per SM;
//    blocks take units in increasing order from a counter as they go.
//  - Loads: a producer warp keeps a ring of 4 chunks (32 rows x 256
//    columns, 32 KB) in flight in shared memory, one TMA box each,
//    completing on the slot's mbarrier, with an evict-first L2 policy (the
//    volume passes once; the partials, stored evict-last, must stay in L2
//    until their merge).  Eight consumer warps compute on the chunks that
//    have arrived and hand each slot back as soon as their rows are in
//    registers.  A volume whose rows are not 16-byte aligned (S not a
//    multiple of 4, an unaligned pointer) is copied by the producer warp's
//    threads instead.
//  - Rows: warp w takes rows 4w..4w+3 of a chunk, lane l columns
//    4l..4l+3 and 128+4l..128+4l+3.  A row's statistics over the strip
//    are warp reductions that exchange halves of the 4 rows (so 28
//    shuffles serve 4 rows, not 80): the max first, then the sums against
//    it, written as one 16-byte partial per row and strip.
//  - Columns: each lane carries its 8 columns' statistics down the warp's
//    rows of the whole band in registers: the exact max, and the sums
//    against a reference that moves (rescaling the sums) only when a chunk
//    brings a value 2^32 above it in exp2 units, so the rescale is rare.
//  - Exponents: exp2(v*k - mk) with one rounding (an FFMA), mk = m*k
//    rounded; the sums are multiplied by 2^-(m*k - mk) once, so each term
//    is exp2((v - m) * k) to the rounding of its exponent.
//  - Merges: at a unit's end the consumers put their column statistics in
//    shared memory and go on with the next unit; three merger warps merge
//    the eight warps' statistics into one 16-byte partial per column and
//    band, then add one to an arrival counter for the unit's row group
//    (batch element, band) and one for its column group (batch element,
//    strip).  The block that arrives last in a group merges the group's
//    partials in index order into the outputs and sets the counter back to
//    0, so a launch leaves the counters as it found them (all 0) and no
//    memset is needed.  A block's last unit the consumers finish
//    themselves, with all their threads.
// The partials are 16 bytes per row and strip plus 16 per column and band
// (7.9 MB at B 6 and 1.6 MB at B 1, Q = S = 4096: about 2 % of the volume).
//
// The backward is one elementwise pass: each block stages its 64 rows'
// statistics and cotangents in shared memory, each thread keeps its 4
// columns' in registers and streams 16 bytes of c in and 16 bytes of dc out
// per row.  exp((v-m)/beta) is exp2((v-m) * log2(e)/beta).  Every sum, in
// both kernels, has a fixed order (whichever block takes a unit or merges
// a group), so results are reproducible run to run.  Ragged edges (Q, S not
// multiples of the tiles, S not a multiple of 4) are masked.

#include <math.h>

#include "hopper.cuh"

namespace coponerf {

constexpr int kBTQ = 64;             // backward tile rows
constexpr int kBTS = 256;            // backward tile columns: 64 threads x 4
constexpr double kLog2e = 1.4426950408889634;

namespace k5f {                      // the forward kernel's shape
constexpr int kW = 256;              // strip columns
constexpr int kR = 32;               // chunk rows
constexpr int kCW = 8;               // consumer warps
constexpr int kRW = kR / kCW;        // a consumer warp's rows in a chunk
static_assert(kRW == 4, "rows_max, rows_sum and rows_xy take 4 rows");
constexpr int kMW = 3;               // merger warps
constexpr int kStages = 4;           // chunks in flight
constexpr int kThreads = (kCW + 1 + kMW) * 32;  // and the producer warp
constexpr int kStageFloats = kR * kW;
constexpr int kColFields = 4;        // per warp and column: max, then z, sum e*x, sum e*y against it
constexpr size_t kSmem = sizeof(float) * (static_cast<size_t>(kStages) * kStageFloats + kColFields * kCW * kW) +
                         sizeof(uint64_t) * (2 * kStages + 2) + sizeof(int) * (kStages + 5);
constexpr float kMove = 32.0f;       // exp2 units above a column's reference that move it
}  // namespace k5f

// four consecutive values of one row starting at column s0; missing ones
// (s >= S) read as -inf, which every max ignores and every exp maps to 0
__device__ __forceinline__ void load4(const float* row, int s0, int S, bool vec, float (&v)[4]) {
  if (vec && s0 + 3 < S) {
    load16(row + s0, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = s0 + e < S ? row[s0 + e] : -INFINITY;
  }
}

// 2^x in one MUFU.EX2 (flushing results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr unsigned kAll = 0xffffffffu;

// L2 policies: the volume streams through once (evicted first), while the
// partial statistics must stay until their merge (evicted last)
__device__ __forceinline__ uint64_t l2_policy_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_policy_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// tma_load_3d with an L2 policy
__device__ __forceinline__ void tma_load_3d_hint(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                                 int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1, {%3, "
      "%4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// a 16-byte store with an L2 policy
__device__ __forceinline__ void store_hint(float4* p, float4 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w), "l"(policy)
               : "memory");
}

// named barrier BAR among NT threads
template <int BAR, int NT>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(NT) : "memory");
}

// The maxima of a warp's 4 rows from each lane's maxima m over its 8
// values.  Two halving exchanges (xor 16, then 8: a lane keeps half of its
// rows and sends the other half) leave each lane one row, row lane / 8,
// over 4 lanes; a butterfly (xor 4, 2, 1) completes it over the 8 lanes
// that hold that row.  Returns the lane's row's max; all[r] gets row r's.
// 10 shuffles for 4 rows, where a butterfly a row takes 20.
__device__ __forceinline__ float rows_max(const float (&m)[4], float (&all)[4], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8;
  float a = h4 ? m[2] : m[0], b = h4 ? m[3] : m[1];
  a = fmaxf(a, __shfl_xor_sync(kAll, h4 ? m[0] : m[2], 16));
  b = fmaxf(b, __shfl_xor_sync(kAll, h4 ? m[1] : m[3], 16));
  float r = h3 ? b : a;
  r = fmaxf(r, __shfl_xor_sync(kAll, h3 ? a : b, 8));
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) r = fmaxf(r, __shfl_xor_sync(kAll, r, o));
#pragma unroll
  for (int i = 0; i < 4; ++i) all[i] = __shfl_sync(kAll, r, 8 * i);
  return r;
}

// The sums over the warp of its 4 rows' (z, sx, sy), the same exchanges:
// each lane ends with row lane / 8's, in a fixed order (18 shuffles, not 60).
__device__ __forceinline__ float3 rows_sum(const float (&z)[4], const float (&x)[4], const float (&y)[4], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8;
  float za = h4 ? z[2] : z[0], zb = h4 ? z[3] : z[1];
  float xa = h4 ? x[2] : x[0], xb = h4 ? x[3] : x[1];
  float ya = h4 ? y[2] : y[0], yb = h4 ? y[3] : y[1];
  za += __shfl_xor_sync(kAll, h4 ? z[0] : z[2], 16);
  zb += __shfl_xor_sync(kAll, h4 ? z[1] : z[3], 16);
  xa += __shfl_xor_sync(kAll, h4 ? x[0] : x[2], 16);
  xb += __shfl_xor_sync(kAll, h4 ? x[1] : x[3], 16);
  ya += __shfl_xor_sync(kAll, h4 ? y[0] : y[2], 16);
  yb += __shfl_xor_sync(kAll, h4 ? y[1] : y[3], 16);
  float zr = h3 ? zb : za, xr = h3 ? xb : xa, yr = h3 ? yb : ya;
  zr += __shfl_xor_sync(kAll, h3 ? za : zb, 8);
  xr += __shfl_xor_sync(kAll, h3 ? xa : xb, 8);
  yr += __shfl_xor_sync(kAll, h3 ? ya : yb, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    zr += __shfl_xor_sync(kAll, zr, o);
    xr += __shfl_xor_sync(kAll, xr, o);
    yr += __shfl_xor_sync(kAll, yr, o);
  }
  return make_float3(zr, xr, yr);
}

// merge the n partials (m, z, sum e*x, sum e*y) of each of R rows or
// columns, p[r] + j * stride, in index order: 16 of each in flight at a
// time, each group's max taken before its sums, the running sums rescaled
// to it
template <int R>
__device__ __forceinline__ void merge_partials(const float4* const (&p)[R], long long stride, int n, float k,
                                               float4 (&out)[R]) {
  constexpr int G = 16;
  float m[R], z[R], sx[R], sy[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    z[r] = sx[r] = sy[r] = 0.0f;
  }
  for (int j0 = 0; j0 < n; j0 += G) {
    float4 a[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < G; ++i)
        a[r][i] = j0 + i < n ? __ldcg(p[r] + (j0 + i) * stride) : make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float gm = m[r];
#pragma unroll
      for (int i = 0; i < G; ++i) gm = fmaxf(gm, a[r][i].x);
      const float f = ex2((m[r] - gm) * k);
      z[r] *= f;
      sx[r] *= f;
      sy[r] *= f;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (j0 + i < n) {
          const float e = ex2((a[r][i].x - gm) * k);
          z[r] = fmaf(a[r][i].y, e, z[r]);
          sx[r] = fmaf(a[r][i].z, e, sx[r]);
          sy[r] = fmaf(a[r][i].w, e, sy[r]);
        }
      }
      m[r] = gm;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = make_float4(m[r], z[r], sx[r], sy[r]);
}

// the x and y coordinates of rows q..q+3 (0 past Q); q a multiple of 4
__device__ __forceinline__ void rows_xy(const float* __restrict__ xq, const float* __restrict__ yq, int q, int Q,
                                        float (&x)[4], float (&y)[4]) {
  if (q + 4 <= Q) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(xq + q));
    const float4 b = __ldg(reinterpret_cast<const float4*>(yq + q));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    y[0] = b.x; y[1] = b.y; y[2] = b.z; y[3] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = q + i < Q ? xq[q + i] : 0.0f;
      y[i] = q + i < Q ? yq[q + i] : 0.0f;
    }
  }
}

// Decode of unit u: batch element b, strip (first column s0, width
// columns), band rows [q_begin, q_end).
struct Unit {
  int b, strip, band, s0, width, q_begin, q_end;
  __device__ __forceinline__ Unit(int u, int Q, int S, int nstrips, int nbands, int h) {
    strip = u % nstrips;
    band = (u / nstrips) % nbands;
    b = u / (nstrips * nbands);
    s0 = strip * k5f::kW;
    width = min(k5f::kW, S - s0);
    q_begin = band * h * k5f::kR;
    q_end = min(Q, q_begin + h * k5f::kR);
  }
};

// Everything about the unit after its chunks, run by NT threads (t their
// index) that meet at named barrier `bar`: the unit's column partials from
// the warps' statistics in cs (moved to their maxima), then its arrivals,
// and for the last arrival of a group that group's merge.  `read` runs
// once cs has been read.  flags: two ints of the caller's own.
struct Args {
  float* row;
  float* col;
  float4* rowp;
  float4* colp;
  unsigned* cnt;
  int B, Q, S, nstrips, nbands, h;
  float k;
};

template <int NT, int BAR, typename Read>
__device__ __forceinline__ void finish_unit(const Args& a, int u, int t, const float* cs, int* flags,
                                            uint64_t keep, Read read) {
  using namespace k5f;
  const Unit un(u, a.Q, a.S, a.nstrips, a.nbands, a.h);
  const int b = un.b, s0 = un.s0, width = un.width, Q = a.Q, S = a.S;
  for (int j = t; j < width; j += NT) {  // the warps' statistics merged in warp order
    float m = cs[j];
    for (int w = 1; w < kCW; ++w) m = fmaxf(m, cs[w * kW + j]);
    float z = 0.0f, sx = 0.0f, sy = 0.0f;
    for (int w = 0; w < kCW; ++w) {
      const float* p = cs + w * kW + j;
      const float e = ex2((p[0] - m) * a.k);  // a warp without rows: max -inf, sums 0
      z = fmaf(p[kCW * kW], e, z);
      sx = fmaf(p[2 * kCW * kW], e, sx);
      sy = fmaf(p[3 * kCW * kW], e, sy);
    }
    store_hint(a.colp + static_cast<long long>(b * a.nbands + un.band) * S + s0 + j, make_float4(m, z, sx, sy),
               keep);
  }
  __threadfence();  // this unit's partials, before its arrivals
  named_sync<BAR, NT>();
  read();
  if (t == 0) {
    unsigned* rc = a.cnt + b * a.nbands + un.band;
    unsigned* cc = a.cnt + a.B * a.nbands + b * a.nstrips + un.strip;
    const bool last_row = atomicAdd(rc, 1u) == static_cast<unsigned>(a.nstrips - 1);
    const bool last_col = atomicAdd(cc, 1u) == static_cast<unsigned>(a.nbands - 1);
    if (last_row) atomicExch(rc, 0u);
    if (last_col) atomicExch(cc, 0u);
    flags[0] = last_row;
    flags[1] = last_col;
  }
  named_sync<BAR, NT>();
  const bool merge_rows = flags[0], merge_cols = flags[1];
  if (merge_rows) {  // the last of the band's strips: merge its rows over the strips
    __threadfence();
    const float4* pb = a.rowp + static_cast<long long>(b) * a.nstrips * Q;
    float* o = a.row + static_cast<long long>(b) * 4 * Q;
    for (int q = un.q_begin + t; q < un.q_end; q += 2 * NT) {  // two rows a thread at a time
      const int q2 = min(q + NT, un.q_end - 1);                 // (the last row again where none is left)
      const float4* const p[2] = {pb + q, pb + q2};
      float4 r[2];
      merge_partials<2>(p, Q, a.nstrips, a.k, r);
      o[q] = r[0].x;
      o[Q + q] = r[0].y;
      o[2 * Q + q] = r[0].z;
      o[3 * Q + q] = r[0].w;
      o[q2] = r[1].x;
      o[Q + q2] = r[1].y;
      o[2 * Q + q2] = r[1].z;
      o[3 * Q + q2] = r[1].w;
    }
  }
  if (merge_cols) {  // the last of the strip's bands: merge its columns over the bands
    __threadfence();
    float* o = a.col + static_cast<long long>(b) * 4 * S;
    for (int j = t; j < width; j += NT) {
      const int s = s0 + j;
      const float4* const p[1] = {a.colp + static_cast<long long>(b) * a.nbands * S + s};
      float4 r[1];
      merge_partials<1>(p, S, a.nbands, a.k, r);
      o[s] = r[0].x;
      o[S + s] = r[0].y;
      o[2 * S + s] = r[0].z;
      o[3 * S + s] = r[0].w;
    }
  }
}

// The forward statistics in one launch: row (B, 4, Q) and col (B, 4, S).
// rowp (B, nstrips, Q) and colp (B, nbands, S) float4 partials; cnt holds
// B*nbands row-group counters, B*nstrips column-group counters, then the
// next unit to take and the blocks done taking, all 0 on entry and on exit.
// Unit u: strip u % nstrips, band (u / nstrips) % nbands, batch element
// u / (nstrips * nbands); a band is h chunks.  Blocks take units in
// increasing order as they go.  With `tma` the chunks come as TMA boxes of
// `map` (c as (B, Q, S), boxes of 1 x 32 x 256, zeros past the edges),
// else the producer warp copies them.  Warps: kCW consumers, the
// producer, kMW mergers (a unit's merges while the consumers go on).
__global__ void __launch_bounds__(k5f::kThreads, 1)
    soft_argmax_stats_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ c,
                             const float* __restrict__ xs, const float* __restrict__ ys,
                             const float* __restrict__ xq, const float* __restrict__ yq, Args a, int units,
                             bool tma) {
  using namespace k5f;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  float* cs = stages + kStages * kStageFloats;  // [kColFields][kCW][kW]
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + kColFields * kCW * kW);
  uint64_t* empty = full + kStages;
  uint64_t* cs_full = empty + kStages;  // cs written (and cs_unit set) by the consumers
  uint64_t* cs_free = cs_full + 1;      // cs read by the mergers
  int* slot_unit = reinterpret_cast<int*>(cs_free + 1);  // the unit of each slot's chunk, -1: the end
  int* cs_unit = slot_unit + kStages;                    // the unit in cs, -1: the end
  int* flags = cs_unit + 1;                              // the consumers' two, the mergers' two
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Q = a.Q, S = a.S, nstrips = a.nstrips, nbands = a.nbands, h = a.h;
  const float k = a.k;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kCW);
    }
    mbar_init(cs_full, kCW);
    mbar_init(cs_free, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint64_t keep = l2_policy_last();

  if (warp > kCW) {  // the mergers
    const int t = threadIdx.x - (kCW + 1) * 32;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(cs_full, phase);
      phase ^= 1;
      const int u = *cs_unit;
      if (u < 0) return;
      finish_unit<kMW * 32, 2>(a, u, t, cs, flags + 2, keep, [&]() {
        if (t == 0) mbar_arrive(cs_free);
      });
    }
  }

  if (warp == kCW) {  // the producer: takes units in turn and keeps the ring full
    unsigned* work = a.cnt + a.B * (nbands + nstrips);  // the next unit to take, then the blocks done taking
    auto take = [&]() {
      int u = 0;
      if (lane == 0) u = static_cast<int>(atomicAdd(work, 1u));
      return __shfl_sync(kAll, u, 0);
    };
    const uint64_t stream_policy = l2_policy_first();
    int slot = 0;
    uint32_t phase = 0;
    int u = take();
    for (;;) {
      const int next = u < units ? take() : units;  // one ahead: its latency under this unit's loads
      mbar_wait(&empty[slot], phase ^ 1);
      if (lane == 0) slot_unit[slot] = u < units ? u : -1;
      if (u >= units) {  // the end: consumers stop at this slot
        if (lane == 0) {
          mbar_arrive(&full[slot]);
          if (atomicAdd(work + 1, 1u) == gridDim.x - 1) {  // every block is done taking: reset for the next launch
            atomicExch(work, 0u);
            atomicExch(work + 1, 0u);
          }
        }
        return;
      }
      const Unit n(u, Q, S, nstrips, nbands, h);
      for (int q0 = n.q_begin; q0 < n.q_end; q0 += kR) {
        if (q0 != n.q_begin) {
          mbar_wait(&empty[slot], phase ^ 1);
          if (lane == 0) slot_unit[slot] = u;
        }
        float* dst = stages + slot * kStageFloats;
        if (tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[slot], kStageFloats * 4);
            tma_load_3d_hint(dst, &map, &full[slot], n.s0, q0, n.b, stream_policy);
          }
        } else {
          const int rows = min(kR, Q - q0);
          const float* src = c + (static_cast<long long>(n.b) * Q + q0) * S + n.s0;
          for (int i = lane; i < rows * kW; i += 32) {
            const int r = i / kW, j = i % kW;
            dst[i] = j < n.width ? src[static_cast<long long>(r) * S + j] : 0.0f;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[slot]);
        }
        if (++slot == kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
      u = next;
    }
  }

  // the consumers: lane columns 4*lane + j and 128 + 4*lane + j (strip-local)
  int cj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cj[j] = (j < 4 ? 4 * lane : 128 + 4 * lane) + (j & 3);
  int slot = 0;
  uint32_t phase = 0, cs_phase = 0;
  mbar_wait(&full[slot], phase);  // the first unit's first chunk, or the end
  int u = slot_unit[slot];
  const bool none = u < 0;
  while (u >= 0) {
    const Unit un(u, Q, S, nstrips, nbands, h);
    const int b = un.b, s0 = un.s0, width = un.width, q_begin = un.q_begin, q_end = un.q_end;
    float xc[8], yc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xc[j] = cj[j] < width ? xs[s0 + cj[j]] : 0.0f;
      yc[j] = cj[j] < width ? ys[s0 + cj[j]] : 0.0f;
    }
    // this warp's column statistics down the band: the exact max, and the
    // sums of exp2(v*k - ck) against a reference exponent ck
    float cmax[8], ck[8], cz[8], csx[8], csy[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cmax[j] = ck[j] = -INFINITY;
      cz[j] = csx[j] = csy[j] = 0.0f;
    }
    float4* rp = a.rowp + static_cast<long long>(b * nstrips + un.strip) * Q;
    const int r0 = warp * kRW;  // the warp's first row in a chunk
    float xn[kRW], yn[kRW];     // the coordinates of the warp's rows in the next chunk
    rows_xy(xq, yq, q_begin + r0, Q, xn, yn);

    for (int q0 = q_begin; q0 < q_end; q0 += kR) {
      const int rows = min(kR, Q - q0);
      float xr[kRW], yr[kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        xr[i] = xn[i];
        yr[i] = yn[i];
      }
      if (q0 + kR < q_end) rows_xy(xq, yq, q0 + kR + r0, Q, xn, yn);
      mbar_wait(&full[slot], phase);
      const float* st = stages + slot * kStageFloats + r0 * kW;
      float v[kRW][8];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const float4 lo = *reinterpret_cast<const float4*>(st + i * kW + 4 * lane);
        const float4 hi = *reinterpret_cast<const float4*>(st + i * kW + 128 + 4 * lane);
        v[i][0] = lo.x; v[i][1] = lo.y; v[i][2] = lo.z; v[i][3] = lo.w;
        v[i][4] = hi.x; v[i][5] = hi.y; v[i][6] = hi.z; v[i][7] = hi.w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);  // the slot's rows are in registers
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
      if (r0 >= rows) continue;  // no row of this warp in the chunk
      if (rows < kR || width < kW) {  // a ragged chunk: rows past Q, columns past S read as -inf
#pragma unroll
        for (int i = 0; i < kRW; ++i) {
          const bool live = r0 + i < rows;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!live || cj[j] >= width) v[i][j] = -INFINITY;
        }
      }

      // the rows' maxima over the strip, the columns' over the warp's rows
      float lm[kRW], mr[kRW], cm[8];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        lm[i] = v[i][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) lm[i] = fmaxf(lm[i], v[i][j]);
      }
      const float my_max = rows_max(lm, mr, lane);
      bool move = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cm[j] = v[0][j];
#pragma unroll
        for (int i = 1; i < kRW; ++i) cm[j] = fmaxf(cm[j], v[i][j]);
        cmax[j] = fmaxf(cmax[j], cm[j]);
        cm[j] *= k;
        move |= cm[j] - ck[j] > kMove;
      }
      if (__any_sync(kAll, move)) {  // a unit's first chunk, or a value far above a column's reference
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (cm[j] - ck[j] > kMove) {
            const float f = ex2(ck[j] - cm[j]);
            cz[j] *= f;
            csx[j] *= f;
            csy[j] *= f;
            ck[j] = cm[j];
          }
        }
      }

      // the sums: exp2(v*k - mk) with one rounding, mk = m*k rounded, then
      // the rows' sums times 2^-(m*k - mk) (below), so that each term is
      // exp2((v - m) * k) to the rounding of its exponent
      float mk[kRW], z[kRW], sx[kRW], sy[kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        mk[i] = mr[i] * k;
        z[i] = sx[i] = sy[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float e = ex2(fmaf(v[i][j], k, -mk[i]));
          z[i] += e;
          sx[i] = fmaf(e, xc[j], sx[i]);
          sy[i] = fmaf(e, yc[j], sy[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < kRW; ++i) {
          const float e = ex2(fmaf(v[i][j], k, -ck[j]));
          cz[j] += e;
          csx[j] = fmaf(e, xr[i], csx[j]);
          csy[j] = fmaf(e, yr[i], csy[j]);
        }
      }
      const float3 rs = rows_sum(z, sx, sy, lane);
      const int r = r0 + lane / 8;  // the lane's row
      if (lane % 8 == 0 && r < rows) {
        const float my_mk = my_max * k;
        const float f = ex2(-fmaf(my_max, k, -my_mk));
        store_hint(rp + q0 + r, make_float4(my_max, rs.x * f, rs.y * f, rs.z * f), keep);
      }
    }

    // the unit's end: this warp's column statistics into cs, moved to their
    // maxima (from ck to cmax*k rounded, then the rounding)
    mbar_wait(cs_free, cs_phase ^ 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float hi = cmax[j] * k;
      const float f = cz[j] > 0.0f ? ex2(ck[j] - hi) * ex2(-fmaf(cmax[j], k, -hi)) : 0.0f;  // 0: no rows
      float* p = cs + warp * kW + cj[j];
      p[0] = cmax[j];
      p[kCW * kW] = cz[j] * f;
      p[2 * kCW * kW] = csx[j] * f;
      p[3 * kCW * kW] = csy[j] * f;
    }
    __threadfence();                // the unit's row partials, before its arrivals
    mbar_wait(&full[slot], phase);  // the next unit's first chunk, or the end
    const int next = slot_unit[slot];
    if (next < 0) {  // the block's last unit: finished here, by all the consumers
      named_sync<1, kCW * 32>();
      finish_unit<kCW * 32, 1>(a, u, threadIdx.x, cs, flags, keep, [] {});
    }
    if (warp == 0 && lane == 0) *cs_unit = next < 0 ? -1 : u;  // to the mergers: this unit, or stop
    __syncwarp();
    if (lane == 0) mbar_arrive(cs_full);
    cs_phase ^= 1;
    u = next;
  }
  if (none) {  // no unit at all: stop the mergers
    if (warp == 0 && lane == 0) *cs_unit = -1;
    __syncwarp();
    if (lane == 0) mbar_arrive(cs_full);
  }
}

// backward: dc (B, Q, S) from c, the finalized row (B, 4, Q) and column
// (B, 4, S) statistics (m, z, gx, gy) and the cotangents dr (B, 2, Q) and
// dcol (B, 2, S)
__global__ void __launch_bounds__(256)
    soft_argmax_bwd_kernel(const float* __restrict__ c, const float* __restrict__ rowf,
                           const float* __restrict__ colf, const float* __restrict__ dr,
                           const float* __restrict__ dcol, const float* __restrict__ xs,
                           const float* __restrict__ ys, const float* __restrict__ xq,
                           const float* __restrict__ yq, float* __restrict__ out, int Q, int S,
                           float k, float inv_b, bool vec) {
  // per row: m1, 1/z1, gx1, gy1, dgx1, dgy1, xq, yq
  __shared__ float rs[8][kBTQ];
  const int sb = blockIdx.x, qb = blockIdx.y, b = blockIdx.z;
  const int s0 = sb * kBTS + 4 * (threadIdx.x % 64), q0 = qb * kBTQ;
  const long long bQ = static_cast<long long>(b) * Q, bS = static_cast<long long>(b) * S;
  if (threadIdx.x < kBTQ) {
    const int r = threadIdx.x, q = q0 + r;
    if (q < Q) {
      const float* f = rowf + 4 * bQ + q;
      rs[0][r] = f[0];
      rs[1][r] = 1.0f / f[Q];
      rs[2][r] = f[2 * Q];
      rs[3][r] = f[3 * Q];
      rs[4][r] = dr[2 * bQ + q];
      rs[5][r] = dr[2 * bQ + Q + q];
      rs[6][r] = xq[q];
      rs[7][r] = yq[q];
    }
  }
  // the thread's 4 columns: m2, 1/z2, gx2, gy2, dgx2, dgy2, xs, ys
  float m2[4], iz2[4], gx2[4], gy2[4], dgx2[4], dgy2[4], xc[4], yc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int s = s0 + e;
    const bool ok = s < S;
    const float* f = colf + 4 * bS + s;
    m2[e] = ok ? f[0] : 0.0f;
    iz2[e] = ok ? 1.0f / f[S] : 0.0f;
    gx2[e] = ok ? f[2 * S] : 0.0f;
    gy2[e] = ok ? f[3 * S] : 0.0f;
    dgx2[e] = ok ? dcol[2 * bS + s] : 0.0f;
    dgy2[e] = ok ? dcol[2 * bS + S + s] : 0.0f;
    xc[e] = ok ? xs[s] : 0.0f;
    yc[e] = ok ? ys[s] : 0.0f;
  }
  __syncthreads();
  if (s0 >= S) return;
  const float* cb = c + bQ * S;
  float* ob = out + bQ * S;
  const bool full = vec && s0 + 3 < S;
#pragma unroll 4
  for (int r = threadIdx.x / 64; r < kBTQ; r += 4) {
    const int q = q0 + r;
    if (q >= Q) break;
    const float m1 = rs[0][r], iz1 = rs[1][r], gx1 = rs[2][r], gy1 = rs[3][r];
    const float dgx1 = rs[4][r], dgy1 = rs[5][r], xqr = rs[6][r], yqr = rs[7][r];
    float v[4], o[4];
    load4(cb + static_cast<long long>(q) * S, s0, S, vec, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p1 = exp2f((v[e] - m1) * k) * iz1;
      const float p2 = exp2f((v[e] - m2[e]) * k) * iz2[e];
      const float t1 = (xc[e] - gx1) * dgx1 + (yc[e] - gy1) * dgy1;
      const float t2 = (xqr - gx2[e]) * dgx2[e] + (yqr - gy2[e]) * dgy2[e];
      o[e] = (p1 * t1 + p2 * t2) * inv_b;
    }
    float* orow = ob + static_cast<long long>(q) * S + s0;
    if (full) {
      store16(orow, o);
    } else {
      for (int e = 0; e < 4 && s0 + e < S; ++e) orow[e] = o[e];
    }
  }
}

// the forward's decomposition on the current device
struct StatsPlan {
  int nstrips, nbands, h, units, grid;
  long long scratch_floats, counters;
};

// bands of whole chunks, chosen so that the units spread most evenly over
// one block per SM: the fewest chunks a block streams, counting a unit's
// merges as one more chunk, the fewest bands on a tie
static bool stats_plan(int B, int Q, int S, int dev, StatsPlan* p) {
  using namespace k5f;
  if (B <= 0 || Q <= 0 || S <= 0 || dev < 0 || dev >= 64) return false;
  static int sm_counts[64] = {};  // per device, read once
  if (sm_counts[dev] <= 0) cudaDeviceGetAttribute(&sm_counts[dev], cudaDevAttrMultiProcessorCount, dev);
  const int sms = sm_counts[dev];
  if (sms <= 0) return false;
  p->nstrips = (S + kW - 1) / kW;
  const int nqc = (Q + kR - 1) / kR;
  const int most = nqc < 8 * sms ? nqc : 8 * sms;
  long long best = -1;
  for (int nb = 1; nb <= most; ++nb) {
    const int h = (nqc + nb - 1) / nb;
    if ((nqc + h - 1) / h != nb) continue;  // the same bands as fewer of them
    const long long units = static_cast<long long>(B) * p->nstrips * nb;
    const long long grid = units < sms ? units : sms;
    const long long cost = (units + grid - 1) / grid * (h + 1);
    if (best < 0 || cost < best) {
      best = cost;
      p->nbands = nb;
      p->h = h;
    }
  }
  const long long units = static_cast<long long>(B) * p->nstrips * p->nbands;
  if (units >= (1LL << 31)) return false;
  p->units = static_cast<int>(units);
  p->grid = p->units < sms ? p->units : sms;
  p->scratch_floats = 4LL * B * (static_cast<long long>(p->nstrips) * Q + static_cast<long long>(p->nbands) * S);
  p->counters = static_cast<long long>(B) * (p->nbands + p->nstrips) + 2;
  return true;
}

// c (B, Q, S) f32 as a TMA map of 1 x 32 x 256 boxes (no swizzle), zeros
// past its edges; S a multiple of 4 and c 16-byte aligned
static bool f32_volume_map(CUtensorMap* map, const float* c, int B, int Q, int S) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(Q), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(S) * 4, static_cast<cuuint64_t>(S) * Q * 4};
  const cuuint32_t box[3] = {k5f::kW, k5f::kR, 1}, elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(c), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// f32_volume_map, kept for the next call of the same thread with the same
// pointer and shape (a map holds nothing else): an encode costs host time
static bool volume_map(CUtensorMap* map, const float* c, int B, int Q, int S) {
  thread_local const float* key_c = nullptr;
  thread_local int key_b = 0, key_q = 0, key_s = 0;
  thread_local CUtensorMap kept;
  if (c != key_c || B != key_b || Q != key_q || S != key_s) {
    key_c = nullptr;
    if (!f32_volume_map(&kept, c, B, Q, S)) return false;
    key_c = c;
    key_b = B;
    key_q = Q;
    key_s = S;
  }
  *map = kept;
  return true;
}

}  // namespace coponerf

// B, Q, S -> the f32 scratch (partials) that k5_soft_argmax_stats needs on
// the current device; -1 if it takes no such shape
extern "C" long long k5_stats_scratch_floats(int B, int Q, int S) {
  coponerf::StatsPlan p;
  int dev = 0;
  cudaGetDevice(&dev);
  return coponerf::stats_plan(B, Q, S, dev, &p) ? p.scratch_floats : -1;
}

// c (B, Q, S) f32; xs, ys (S,) and xq, yq (Q,) coordinates; out row
// (B, 4, Q), col (B, 4, S); scratch: k5_stats_scratch_floats floats;
// counters: at least B * (ceil(Q / 32) + ceil(S / 256)) + 2 zeros, which the
// launch leaves zero (one set per stream: two launches in flight at once
// must not share them)
extern "C" int k5_soft_argmax_stats(const void* c, const void* xs, const void* ys, const void* xq,
                                    const void* yq, void* row, void* col, void* scratch,
                                    long long scratch_floats, void* counters, long long n_counters, int B,
                                    int Q, int S, double beta, void* stream) {
  using namespace coponerf;
  if (B <= 0 || Q <= 0 || S <= 0) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  StatsPlan p;
  if (!stats_plan(B, Q, S, dev, &p) || scratch_floats < p.scratch_floats || n_counters < p.counters)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set[64] = {};  // per device: the shared-memory limit raised once
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        soft_argmax_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(k5f::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const float* cf = static_cast<const float*>(c);
  // TMA boxes where the rows are 16-byte aligned, else the producer warp's own copies
  CUtensorMap map{};
  const bool tma = S % 4 == 0 && reinterpret_cast<uintptr_t>(cf) % 16 == 0;
  if (tma && !volume_map(&map, cf, B, Q, S)) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.row = static_cast<float*>(row);
  a.col = static_cast<float*>(col);
  a.rowp = static_cast<float4*>(scratch);
  a.colp = a.rowp + static_cast<long long>(B) * p.nstrips * Q;
  a.cnt = static_cast<unsigned*>(counters);
  a.B = B;
  a.Q = Q;
  a.S = S;
  a.nstrips = p.nstrips;
  a.nbands = p.nbands;
  a.h = p.h;
  a.k = static_cast<float>(kLog2e / beta);
  soft_argmax_stats_kernel<<<p.grid, k5f::kThreads, k5f::kSmem, static_cast<cudaStream_t>(stream)>>>(
      map, cf, static_cast<const float*>(xs), static_cast<const float*>(ys), static_cast<const float*>(xq),
      static_cast<const float*>(yq), a, p.units, tma);
  return static_cast<int>(cudaGetLastError());
}

// c (B, Q, S) f32, rowf (B, 4, Q), colf (B, 4, S), dr (B, 2, Q),
// dcol (B, 2, S), coordinates as above; out dc (B, Q, S) f32
extern "C" int k5_soft_argmax_bwd(const void* c, const void* rowf, const void* colf, const void* dr,
                                  const void* dcol, const void* xs, const void* ys, const void* xq,
                                  const void* yq, void* out, int B, int Q, int S, double beta,
                                  void* stream) {
  using namespace coponerf;
  if (B <= 0 || Q <= 0 || S <= 0) return 0;
  const int nSB = (S + kBTS - 1) / kBTS, nQB = (Q + kBTQ - 1) / kBTQ;
  if (nQB > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float k = static_cast<float>(kLog2e / beta);
  const float inv_b = static_cast<float>(1.0 / beta);
  const float* cf = static_cast<const float*>(c);
  float* of = static_cast<float*>(out);
  const bool vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(cf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(of) % 16 == 0;
  soft_argmax_bwd_kernel<<<dim3(nSB, nQB, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      cf, static_cast<const float*>(rowf), static_cast<const float*>(colf),
      static_cast<const float*>(dr), static_cast<const float*>(dcol),
      static_cast<const float*>(xs), static_cast<const float*>(ys), static_cast<const float*>(xq),
      static_cast<const float*>(yq), of, Q, S, k, inv_b, vec);
  return static_cast<int>(cudaGetLastError());
}
