// Per-row strip-reversal sweep for Hopper (sm_90a): the edge-crossing
// count and the crossing-angle deviation sum of every strip bucket.
//
// Replaces the Pallas TPU kernel repro/kernels/strip_reversal.py
// (_reversal_kernel / strip_reversal_stats).  For each row of a
// (rows, cap) slab it counts the pairs (i, j) with
//     yl_i < yl_j  &&  yr_i > yr_j,  no shared endpoint, both valid
// and, with_angle, sums |ideal - min(d, pi - d)| / ideal, d = |th_i - th_j|,
// over the same pairs -- by true (IEEE) division, as the reference does.
//
// What bounds the function: per-pair ALU work on the CUDA cores (float
// compares for the reversal, four int compares for shared endpoints, one
// add; the deviation only on the rare masked pairs).  The input is 21
// bytes per slot, negligible next to the cap^2 pair tests.  There is no
// matrix product here, so no tensor-core work.  What bounds this design
// before the ALU (read from the code, not measured): with one i per
// thread every pair costs five shared-memory loads (yl, yr, v, u, ok)
// against about three FP32 issue slots, so the load/store pipe binds
// first; and the j loop sweeps the whole cap of every row, padding
// included, although the valid slots are a prefix of the row.
//
// Design: grid (rows, ceil(cap / blockDim.x)).  A thread owns one i of
// its block's chunk and keeps that segment in registers; the block
// stages the row's six vectors through shared memory in j-tiles of
// blockDim.x slots, and every thread tests its i against the tile (the
// shared-memory reads are broadcasts).  The chunk axis keeps the 132 SMs
// busy when a tier holds only a few wide strips.  Each thread accumulates
// an int count and an f32 deviation; a fixed-order warp-shuffle and
// shared-memory tree reduces them to one partial per block, which the
// wrapper sums over the chunk axis.  No atomics: every sum has a fixed
// order, so the deviation is the same from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
// pi as the reference's f32 expression rounds it
constexpr float kPi = 3.14159265358979f;

template <bool kWithAngle>
__global__ void __launch_bounds__(kMaxThreads)
strip_reversal_kernel(const float* __restrict__ yl,
                      const float* __restrict__ yr,
                      const float* __restrict__ th,
                      const int32_t* __restrict__ v,
                      const int32_t* __restrict__ u,
                      const uint8_t* __restrict__ ok, int cap, float ideal,
                      int32_t* __restrict__ cnt_out,
                      float* __restrict__ dev_out) {
  __shared__ float s_yl[kMaxThreads];
  __shared__ float s_yr[kMaxThreads];
  __shared__ float s_th[kMaxThreads];
  __shared__ int32_t s_v[kMaxThreads];
  __shared__ int32_t s_u[kMaxThreads];
  __shared__ uint8_t s_ok[kMaxThreads];
  __shared__ int32_t w_cnt[kMaxThreads / 32];
  __shared__ float w_dev[kMaxThreads / 32];

  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * cap;
  const int i = blockIdx.y * nt + tid;

  bool act = false;
  float yli = 0.f, yri = 0.f, thi = 0.f;
  int32_t vi = 0, ui = 0;
  if (i < cap) {
    act = ok[base + i] != 0;
    yli = yl[base + i];
    yri = yr[base + i];
    thi = th[base + i];
    vi = v[base + i];
    ui = u[base + i];
  }

  int count = 0;
  float dev = 0.f;
  for (int j0 = 0; j0 < cap; j0 += nt) {
    const int j = j0 + tid;
    __syncthreads();
    if (j < cap) {
      s_yl[tid] = yl[base + j];
      s_yr[tid] = yr[base + j];
      s_th[tid] = th[base + j];
      s_v[tid] = v[base + j];
      s_u[tid] = u[base + j];
      s_ok[tid] = ok[base + j];
    } else {
      s_ok[tid] = 0;
    }
    __syncthreads();
    if (act) {
      const int jn = min(nt, cap - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const bool rev = (yli < s_yl[jj]) & (yri > s_yr[jj]);
        const int32_t vj = s_v[jj], uj = s_u[jj];
        const bool shared = (vi == vj) | (vi == uj) | (ui == vj) | (ui == uj);
        if (rev & !shared & (s_ok[jj] != 0)) {
          ++count;
          if (kWithAngle) {
            const float d = fabsf(thi - s_th[jj]);
            const float a_c = fminf(d, kPi - d);
            dev += fabsf(ideal - a_c) / ideal;
          }
        }
      }
    }
  }

  // fixed-order block reduction: warp shuffle tree, then warp 0's lane 0
  // adds the per-warp partials in warp order
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
    dev += __shfl_down_sync(0xffffffffu, dev, off);
  }
  if ((tid & 31) == 0) {
    w_cnt[tid >> 5] = count;
    w_dev[tid >> 5] = dev;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    float d = 0.f;
    for (int w = 0; w < nt / 32; ++w) {
      c += w_cnt[w];
      d += w_dev[w];
    }
    const size_t out = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
    cnt_out[out] = c;
    dev_out[out] = d;
  }
}

}  // namespace

// Plain C entry.  threads: a multiple of 32 in [32, 256]; chunks =
// ceil(cap / threads).  Outputs are (rows, chunks) partials.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int strip_reversal_launch(const void* yl, const void* yr,
                                     const void* th, const void* v,
                                     const void* u, const void* ok, int rows,
                                     int cap, float ideal, int with_angle,
                                     int threads, int chunks, void* cnt_out,
                                     void* dev_out, void* stream) {
  const dim3 grid(rows, chunks);
  const dim3 block(threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_yl = static_cast<const float*>(yl);
  const float* f_yr = static_cast<const float*>(yr);
  const float* f_th = static_cast<const float*>(th);
  const int32_t* i_v = static_cast<const int32_t*>(v);
  const int32_t* i_u = static_cast<const int32_t*>(u);
  const uint8_t* b_ok = static_cast<const uint8_t*>(ok);
  int32_t* o_cnt = static_cast<int32_t*>(cnt_out);
  float* o_dev = static_cast<float*>(dev_out);
  if (with_angle) {
    strip_reversal_kernel<true><<<grid, block, 0, s>>>(
        f_yl, f_yr, f_th, i_v, i_u, b_ok, cap, ideal, o_cnt, o_dev);
  } else {
    strip_reversal_kernel<false><<<grid, block, 0, s>>>(
        f_yl, f_yr, f_th, i_v, i_u, b_ok, cap, ideal, o_cnt, o_dev);
  }
  return static_cast<int>(cudaGetLastError());
}
