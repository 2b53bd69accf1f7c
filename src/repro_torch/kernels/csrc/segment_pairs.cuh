// All-pairs segment sweep for Hopper (sm_90a), shared by
// segment_crossing.cu (the exact crossing count) and
// crossing_angle_sum.cu (the count plus the crossing-angle deviation sum).
//
// For the (E_pad, E_pad) edge-pair matrix, cut into (kTile, kTile) tiles,
// it counts the pairs (i, j) with global i < j, both valid, no shared
// endpoint, and the paper's CCW straddle test
//     sign(d1) * sign(d2) <= 0  &&  sign(d3) * sign(d4) <= 0,
// written without sign products as (a <= 0 & b >= 0) | (a >= 0 & b <= 0).
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
// for every pair, so they are formed once per segment; and
// d3 = (q2 - p2) x (p1 - p2) equals -((q2 - p2) x (p2 - p1)) bit for bit,
// because round-to-nearest is symmetric about zero, so d3's straddle test
// reads the negated product with the comparisons swapped.
//
// Invalid slots get NaN coordinates when they are loaded.  Every
// comparison with NaN is false, so such a slot fails the straddle test
// against every segment, exactly as the validity mask would drop it.  A
// valid segment with a NaN coordinate likewise never crosses, as in the
// reference (sign(NaN) is NaN there).
//
// What bounds it on an H100: per-pair ALU work on the CUDA cores, about 30
// operations (six coordinate differences, eight multiplies, four
// subtracts, the two straddle tests, four integer compares for shared
// endpoints, the mask and the count), plus the deviation on crossing
// pairs.  The input is 25 to 29 bytes per edge, read once per tile row,
// negligible next to the E^2 / 2 pair tests.  There is no matrix product,
// so no tensor-core work.
//
// Design: one block per (i tile, j tile).  Tiles wholly below the
// diagonal hold no i < j pair and write 0 without work.  A block stages
// the j tile in shared memory as two 16-byte records per edge (endpoints;
// direction and vertex ids) plus theta, about 9 KB; each thread keeps
// kPerThread i segments in registers and tests them against every j (the
// shared-memory reads are broadcasts).  Each thread accumulates an int
// count and an f32 deviation; a fixed-order warp-shuffle and
// shared-memory tree reduces them to one partial per tile, which the
// wrapper sums in int64 / float64.  No atomics: the deviation sum is the
// same from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segment_pairs {

constexpr int kTile = 256;
constexpr int kThreads = 128;
constexpr int kPerThread = kTile / kThreads;
// pi as the reference's float32 expression rounds it
constexpr float kPi = 3.14159265358979f;

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

// sign(a) * sign(b) <= 0, false when either is NaN
__device__ __forceinline__ bool straddle(float a, float b) {
  return ((a <= 0.f) & (b >= 0.f)) | ((a >= 0.f) & (b <= 0.f));
}

// segment g as its endpoints and direction, NaN when the slot is invalid
__device__ __forceinline__ void load_segment(
    const float* __restrict__ x1, const float* __restrict__ y1,
    const float* __restrict__ x2, const float* __restrict__ y2,
    const uint8_t* __restrict__ ok, int g, Ends& e, float& dx, float& dy) {
  if (ok[g] != 0) {
    e.px = x1[g];
    e.py = y1[g];
    e.qx = x2[g];
    e.qy = y2[g];
  } else {
    e.px = e.py = e.qx = e.qy = __int_as_float(0x7fc00000);
  }
  dx = __fsub_rn(e.qx, e.px);
  dy = __fsub_rn(e.qy, e.py);
}

template <bool kAngle>
__global__ void __launch_bounds__(kThreads)
pair_sweep_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
                  const float* __restrict__ x2, const float* __restrict__ y2,
                  const float* __restrict__ th, const int32_t* __restrict__ v,
                  const int32_t* __restrict__ u,
                  const uint8_t* __restrict__ ok, int n_tiles, float ideal,
                  float recip, int32_t* __restrict__ cnt_out,
                  float* __restrict__ dev_out) {
  __shared__ Ends s_end[kTile];
  __shared__ DirIds s_dir[kTile];
  __shared__ float s_th[kAngle ? kTile : 1];
  __shared__ int32_t w_cnt[kThreads / 32];
  __shared__ float w_dev[kThreads / 32];

  const int bj = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t out = static_cast<size_t>(bi) * n_tiles + bj;
  if (bj < bi) {
    if (tid == 0) {
      cnt_out[out] = 0;
      if (kAngle) dev_out[out] = 0.f;
    }
    return;
  }

  const int j_base = bj * kTile;
  for (int k = tid; k < kTile; k += kThreads) {
    const int g = j_base + k;
    Ends e;
    DirIds d;
    load_segment(x1, y1, x2, y2, ok, g, e, d.dx, d.dy);
    d.v = v[g];
    d.u = u[g];
    s_end[k] = e;
    s_dir[k] = d;
    if (kAngle) s_th[k] = th[g];
  }
  Ends ei[kPerThread];
  float ax[kPerThread], ay[kPerThread], thi[kPerThread];
  int32_t vi[kPerThread], ui[kPerThread];
  int li[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    li[r] = tid + r * kThreads;
    const int g = bi * kTile + li[r];
    load_segment(x1, y1, x2, y2, ok, g, ei[r], ax[r], ay[r]);
    vi[r] = v[g];
    ui[r] = u[g];
    thi[r] = kAngle ? th[g] : 0.f;
  }
  __syncthreads();

  // on the diagonal tile only local i < local j is an i < j pair; off it
  // every pair is
  const int diag = bi == bj;
  int count = 0;
  float dev = 0.f;
#pragma unroll 2
  for (int jj = 0; jj < kTile; ++jj) {
    const Ends ej = s_end[jj];
    const DirIds dj = s_dir[jj];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      // p2 - p1, q2 - p1, q1 - p2
      const float ppx = __fsub_rn(ej.px, ei[r].px);
      const float ppy = __fsub_rn(ej.py, ei[r].py);
      const float qpx = __fsub_rn(ej.qx, ei[r].px);
      const float qpy = __fsub_rn(ej.qy, ei[r].py);
      const float qqx = __fsub_rn(ei[r].qx, ej.px);
      const float qqy = __fsub_rn(ei[r].qy, ej.py);
      const float d1 = cross(ax[r], ay[r], ppx, ppy);
      const float d2 = cross(ax[r], ay[r], qpx, qpy);
      const float n3 = cross(dj.dx, dj.dy, ppx, ppy);  // d3 == -n3
      const float d4 = cross(dj.dx, dj.dy, qqx, qqy);
      const bool s34 = ((n3 >= 0.f) & (d4 >= 0.f)) | ((n3 <= 0.f) & (d4 <= 0.f));
      const bool shared = (vi[r] == dj.v) | (vi[r] == dj.u) |
                          (ui[r] == dj.v) | (ui[r] == dj.u);
      const bool order = !diag | (li[r] < jj);
      if (straddle(d1, d2) & s34 & !shared & order) {
        ++count;
        if (kAngle) {
          const float d = fabsf(__fsub_rn(thi[r], s_th[jj]));
          const float a_c = fminf(d, __fsub_rn(kPi, d));
          const float t = fabsf(__fsub_rn(ideal, a_c));
          dev = __fadd_rn(dev, __fmul_rn(t, recip));
        }
      }
    }
  }

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
    cnt_out[out] = c;
    if (kAngle) dev_out[out] = d;
  }
}

template <bool kAngle>
int launch_pair_sweep(const void* x1, const void* y1, const void* x2,
                      const void* y2, const void* th, const void* v,
                      const void* u, const void* ok, int n, float ideal,
                      float recip, void* cnt_out, void* dev_out,
                      void* stream) {
  const int n_tiles = n / kTile;
  const dim3 grid(n_tiles, n_tiles);
  pair_sweep_kernel<kAngle>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x1), static_cast<const float*>(y1),
          static_cast<const float*>(x2), static_cast<const float*>(y2),
          static_cast<const float*>(th), static_cast<const int32_t*>(v),
          static_cast<const int32_t*>(u), static_cast<const uint8_t*>(ok),
          n_tiles, ideal, recip, static_cast<int32_t*>(cnt_out),
          static_cast<float*>(dev_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segment_pairs
