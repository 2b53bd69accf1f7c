// All-pairs segment sweep for Hopper (sm_90a), shared by
// segment_crossing.cu (the exact crossing count) and
// crossing_angle_sum.cu (the count plus the crossing-angle deviation sum).
//
// For the (E_pad, E_pad) edge-pair matrix, cut into (kTile, kTile) tiles,
// it counts the pairs (i, j) with global i < j, both valid, no shared
// endpoint, and the paper's CCW straddle test
//     sign(d1) * sign(d2) <= 0  &&  sign(d3) * sign(d4) <= 0.
// With kAngle it also sums |ideal - min(d, pi - d)| * recip over the same
// pairs, d = |theta_i - theta_j| and recip the float32 rounding of
// 1 / ideal (the form of the Pallas kernel
// repro/kernels/crossing_angle_sum.py).
//
// Rounding.  Each cross product is (qx - px) * (ry - py) - (qy - py) *
// (rx - px) rounded op by op, as the reference rounds it: the products and
// the difference go through __fmul_rn / __fsub_rn, which nvcc never
// contracts into an FMA (an FMA rounds once and flips the sign of
// near-zero products, i.e. of collinear and T-junction pairs).  Two exact
// identities save work: the differences q1 - p1 and q2 - p2 are the same
// for every pair, so they are formed once per segment; and p1 - p2 is
// -(p2 - p1) bit for bit, because round-to-nearest is symmetric about
// zero, so d3 = (q2 - p2) x (p1 - p2) reads p2 - p1 through negated
// operands (free source modifiers) and equals -n3, n3 = (q2 - p2) x
// (p2 - p1), bit for bit.
//
// The straddle test.  sign(a) * sign(b) <= 0 is min(a, b) <= 0 <= max(a, b)
// when neither is NaN; min.NaN / max.NaN return NaN when either is, and
// every comparison with NaN is false, so a NaN cross product never
// straddles (sign(NaN) is NaN in the reference).  The four compares of
// the two tests and the four of the shared-endpoint test form one chain
// of setp's, each ANDing its result into one predicate (written in PTX,
// since nvcc combines them with extra predicate ops and spills predicates
// to registers), under which the count and the deviation term are added.
//
// Invalid slots get NaN coordinates when they are loaded.  All four cross
// products of a pair with an invalid slot are then NaN, so such a pair
// fails the straddle test, exactly as the validity mask would drop it.  A
// valid segment with a NaN coordinate makes both products of at least one
// test NaN, so it never crosses either, as in the reference.
//
// What bounds it on an H100: per-pair ALU work on the CUDA cores: 31
// issued instructions in the loop's SASS (six coordinate differences,
// eight multiplies, four subtracts, four min/max and four compares for
// the straddle tests, four integer compares for shared endpoints, the
// predicated count), 35 with the angle (three adds for the deviation and
// its predicated add), plus the loop's loads and branch.  The
// input is 25 to 29 bytes per edge, read once per tile, negligible next
// to the E^2 / 2 pair tests.  There is no matrix product (the contraction
// dimension is 2 and the counts are exact), so no tensor-core work.
//
// Design:
// * A 1-D grid of the n_t (n_t + 1) / 2 tiles with bi <= bj, numbered
//   column by column (k = bj (bj + 1) / 2 + bi, as occlusion_pairs.cu), one
//   (count, deviation) partial per tile.  No block exists only to write
//   0; a block whose i tile or j tile holds no valid edge writes 0 at
//   once (__syncthreads_or over the flags it loaded).
// * The j tile is staged in shared memory as two 16-byte records per edge
//   (endpoints; direction and vertex ids) plus theta; each thread keeps
//   kPer i segments in registers (eight in both kernels), so one set of
//   broadcast loads serves kPer pairs; one warp per block.
// * The i < j order is tested only on the diagonal tile, in its own
//   instantiation of the loop; off it every pair is an i < j pair.
// * No branch on a crossing: the count and the deviation are added under
//   the crossing predicate (about a quarter of the pairs cross, so a warp
//   meets one on nearly every j and a divergent branch would be taken on
//   nearly every pair).  Each thread sums |ideal - a_c| per i and
//   multiplies by recip once before the block reduction.
// * Fixed-order reductions: a warp-shuffle tree, then thread 0 adds the
//   per-warp partials in warp order; the wrapper sums the tile partials
//   in int64 / float64.  No atomics: the deviation sum is the same from
//   run to run.
//
// Tuning knobs, chosen by timing on the card with
// tools/time_kernel_variants.py, which sets them with -D: the i's per
// thread (SEGMENT_PAIRS_PER_THREAD) and the j loop's unroll
// (SEGMENT_PAIRS_UNROLL), defaulted by each including .cu.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


namespace segment_pairs {

constexpr int kTile = 256;
constexpr float kHalfPi = 1.5707963267948966f;

struct alignas(16) Ends {
  float px, py, qx, qy;
};
struct alignas(16) DirIds {
  float dx, dy;
  int32_t v, u;
};

// (q - p) x (r - p) given q - p and r - p, rounded op by op
__device__ __forceinline__ float cross(float qpx, float qpy, float rpx,
                                       float rpy) {
  return __fsub_rn(__fmul_rn(qpx, rpy), __fmul_rn(qpy, rpx));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The crossing predicate as one chain of compares: the shared-endpoint
// test, lo12 <= 0 <= hi12 and lo34 <= 0 <= hi34 (lo, hi the NaN-keeping
// min and max of d1, d2 and of d3, d4) and, on the diagonal tile, li < lj;
// under it, one more crossing and, with kAngle, t added to tsum.
#define SP_CHAIN_HEAD                          \
  "{\n\t.reg .pred p;\n\t"                    \
  "setp.ne.s32 p, %2, %4;\n\t"                 \
  "setp.ne.and.s32 p, %2, %5, p;\n\t"          \
  "setp.ne.and.s32 p, %3, %4, p;\n\t"          \
  "setp.ne.and.s32 p, %3, %5, p;\n\t"          \
  "setp.le.and.f32 p, %6, 0f00000000, p;\n\t"  \
  "setp.ge.and.f32 p, %7, 0f00000000, p;\n\t"  \
  "setp.le.and.f32 p, %8, 0f00000000, p;\n\t"  \
  "setp.ge.and.f32 p, %9, 0f00000000, p;\n\t"
#define SP_CHAIN_ORDER "setp.lt.and.s32 p, %10, %11, p;\n\t"
#define SP_CHAIN_COUNT "@p add.s32 %0, %0, 1;\n\t"
#define SP_CHAIN_ANGLE "@p add.rn.f32 %1, %1, %12;\n\t"

template <bool kAngle, bool kDiag>
__device__ __forceinline__ void tally(int vi, int ui, int vj, int uj, int li,
                                      int lj, float lo12, float hi12,
                                      float lo34, float hi34, float t,
                                      int& count, float& tsum) {
#define SP_CHAIN_ARGS                                                       \
  : "+r"(count), "+f"(tsum)                                                 \
  : "r"(vi), "r"(ui), "r"(vj), "r"(uj), "f"(lo12), "f"(hi12), "f"(lo34),    \
    "f"(hi34), "r"(li), "r"(lj), "f"(t)
  if constexpr (kDiag && kAngle)
    asm(SP_CHAIN_HEAD SP_CHAIN_ORDER SP_CHAIN_COUNT SP_CHAIN_ANGLE "}"
        SP_CHAIN_ARGS);
  else if constexpr (kDiag)
    asm(SP_CHAIN_HEAD SP_CHAIN_ORDER SP_CHAIN_COUNT "}" SP_CHAIN_ARGS);
  else if constexpr (kAngle)
    asm(SP_CHAIN_HEAD SP_CHAIN_COUNT SP_CHAIN_ANGLE "}" SP_CHAIN_ARGS);
  else
    asm(SP_CHAIN_HEAD SP_CHAIN_COUNT "}" SP_CHAIN_ARGS);
#undef SP_CHAIN_ARGS
}

// segment g as its endpoints and direction, NaN when the slot is invalid;
// returns whether it is valid
__device__ __forceinline__ bool load_segment(
    const float* __restrict__ x1, const float* __restrict__ y1,
    const float* __restrict__ x2, const float* __restrict__ y2,
    const uint8_t* __restrict__ ok, int g, Ends& e, float& dx, float& dy) {
  const bool valid = ok[g] != 0;
  if (valid) {
    e.px = x1[g];
    e.py = y1[g];
    e.qx = x2[g];
    e.qy = y2[g];
  } else {
    e.px = e.py = e.qx = e.qy = __int_as_float(0x7fc00000);
  }
  dx = __fsub_rn(e.qx, e.px);
  dy = __fsub_rn(e.qy, e.py);
  return valid;
}

// one thread's i segments
template <int kPer>
struct ISegs {
  Ends e[kPer];
  float ax[kPer], ay[kPer], th[kPer];
  int32_t v[kPer], u[kPer];
};

// Sweep the staged j tile against a thread's i's; kDiag adds the order
// test local i < local j of the diagonal tile.
template <bool kAngle, bool kDiag, int kPer, int kUnroll>
__device__ __forceinline__ void sweep(const Ends* s_end, const DirIds* s_dir,
                                      const float* s_th,
                                      const ISegs<kPer>& is, int tid,
                                      float ideal, int (&count)[kPer],
                                      float (&tsum)[kPer]) {
  constexpr int kThreads = kTile / kPer;
  const float ideal_less_half_pi = __fsub_rn(ideal, kHalfPi);
#pragma unroll kUnroll
  for (int jj = 0; jj < kTile; ++jj) {
    const Ends ej = s_end[jj];
    const DirIds dj = s_dir[jj];
    const float thj = kAngle ? s_th[jj] : 0.f;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      // p2 - p1, q2 - p1, q1 - p2
      const float ppx = __fsub_rn(ej.px, is.e[r].px);
      const float ppy = __fsub_rn(ej.py, is.e[r].py);
      const float qpx = __fsub_rn(ej.qx, is.e[r].px);
      const float qpy = __fsub_rn(ej.qy, is.e[r].py);
      const float qqx = __fsub_rn(is.e[r].qx, ej.px);
      const float qqy = __fsub_rn(is.e[r].qy, ej.py);
      const float d1 = cross(is.ax[r], is.ay[r], ppx, ppy);
      const float d2 = cross(is.ax[r], is.ay[r], qpx, qpy);
      const float d3 = cross(dj.dx, dj.dy, -ppx, -ppy);
      const float d4 = cross(dj.dx, dj.dy, qqx, qqy);
      // formed on every lane and added under the crossing predicate
      float t = 0.f;
      if (kAngle) {
        // |ideal - a_c| with a_c = min(d, pi - d) = pi/2 - |pi/2 - d|,
        // d = |theta_i - theta_j| in [0, pi): three adds, no min; the
        // value moves by at most an ulp of pi/2 against the reference's
        // rounding, far inside the rtol 1e-5 parity bar
        const float d = __fsub_rn(is.th[r], thj);
        t = fabsf(__fadd_rn(ideal_less_half_pi,
                            fabsf(__fsub_rn(kHalfPi, fabsf(d)))));
      }
      tally<kAngle, kDiag>(is.v[r], is.u[r], dj.v, dj.u, tid + r * kThreads,
                           jj, min_nan(d1, d2), max_nan(d1, d2),
                           min_nan(d3, d4), max_nan(d3, d4), t, count[r],
                           tsum[r]);
    }
  }
}

template <bool kAngle, int kPer, int kUnroll>
__global__ void __launch_bounds__(kTile / kPer)
pair_sweep_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
                  const float* __restrict__ x2, const float* __restrict__ y2,
                  const float* __restrict__ th, const int32_t* __restrict__ v,
                  const int32_t* __restrict__ u,
                  const uint8_t* __restrict__ ok, float ideal, float recip,
                  int32_t* __restrict__ cnt_out,
                  float* __restrict__ dev_out) {
  constexpr int kThreads = kTile / kPer;
  static_assert(kTile % kPer == 0 && kThreads % 32 == 0,
                "kPer must leave whole warps of a 256-edge tile");
  __shared__ Ends s_end[kTile];
  __shared__ DirIds s_dir[kTile];
  __shared__ float s_th[kAngle ? kTile : 1];
  __shared__ int32_t w_cnt[kThreads / 32];
  __shared__ float w_dev[kThreads / 32];

  // tile k -> (bi, bj), bi <= bj, from k = bj (bj + 1) / 2 + bi
  const long long k = blockIdx.x;
  int bj = static_cast<int>((sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) *
                            0.5);
  while (static_cast<long long>(bj) * (bj + 1) / 2 > k) --bj;
  while (static_cast<long long>(bj + 1) * (bj + 2) / 2 <= k) ++bj;
  const int bi =
      static_cast<int>(k - static_cast<long long>(bj) * (bj + 1) / 2);
  const int tid = threadIdx.x;

  bool any_j = false;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int s = tid + r * kThreads;
    const int g = bj * kTile + s;
    Ends e;
    DirIds d;
    any_j |= load_segment(x1, y1, x2, y2, ok, g, e, d.dx, d.dy);
    d.v = v[g];
    d.u = u[g];
    s_end[s] = e;
    s_dir[s] = d;
    if (kAngle) s_th[s] = th[g];
  }
  ISegs<kPer> is;
  bool any_i = false;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int g = bi * kTile + tid + r * kThreads;
    any_i |= load_segment(x1, y1, x2, y2, ok, g, is.e[r], is.ax[r], is.ay[r]);
    is.v[r] = v[g];
    is.u[r] = u[g];
    is.th[r] = kAngle ? th[g] : 0.f;
  }
  const int has_i = __syncthreads_or(any_i);
  const int has_j = __syncthreads_or(any_j);  // also publishes the j tile
  if (!(has_i && has_j)) {
    if (tid == 0) {
      cnt_out[k] = 0;
      if (kAngle) dev_out[k] = 0.f;
    }
    return;
  }

  int counts[kPer];
  float tsums[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    counts[r] = 0;
    tsums[r] = 0.f;
  }
  if (bi == bj)
    sweep<kAngle, true, kPer, kUnroll>(s_end, s_dir, s_th, is, tid, ideal,
                                       counts, tsums);
  else
    sweep<kAngle, false, kPer, kUnroll>(s_end, s_dir, s_th, is, tid, ideal,
                                        counts, tsums);
  int count = 0;
  float tsum = 0.f;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    count += counts[r];
    tsum = __fadd_rn(tsum, tsums[r]);
  }
  float dev = __fmul_rn(tsum, recip);

  // fixed-order block reduction: warp shuffle tree, then thread 0 adds
  // the per-warp partials in warp order
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
    if (kAngle) dev += __shfl_down_sync(0xffffffffu, dev, off);
  }
  if ((tid & 31) == 0) {
    w_cnt[tid >> 5] = count;
    if (kAngle) w_dev[tid >> 5] = dev;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    float d = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      c += w_cnt[w];
      if (kAngle) d += w_dev[w];
    }
    cnt_out[k] = c;
    if (kAngle) dev_out[k] = d;
  }
}

// n is a multiple of kTile; cnt_out (and dev_out with kAngle) hold one
// partial per tile with bi <= bj: n_t (n_t + 1) / 2 of them, n_t = n /
// kTile.
template <bool kAngle, int kPer, int kUnroll>
int launch_pair_sweep(const void* x1, const void* y1, const void* x2,
                      const void* y2, const void* th, const void* v,
                      const void* u, const void* ok, int n, float ideal,
                      float recip, void* cnt_out, void* dev_out,
                      void* stream) {
  const long long n_tiles = n / kTile;
  const long long blocks = n_tiles * (n_tiles + 1) / 2;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  pair_sweep_kernel<kAngle, kPer, kUnroll>
      <<<static_cast<unsigned>(blocks), kTile / kPer, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x1), static_cast<const float*>(y1),
          static_cast<const float*>(x2), static_cast<const float*>(y2),
          static_cast<const float*>(th), static_cast<const int32_t*>(v),
          static_cast<const int32_t*>(u), static_cast<const uint8_t*>(ok),
          ideal, recip, static_cast<int32_t*>(cnt_out),
          static_cast<float*>(dev_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segment_pairs
