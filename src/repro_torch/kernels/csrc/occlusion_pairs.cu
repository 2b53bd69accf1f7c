// Tiled all-pairs node-occlusion count for Hopper (sm_90a): exact N_c.
//
// Replaces the Pallas TPU kernel repro/kernels/occlusion_pairs.py
// (_occlusion_kernel / occlusion_count).  Counts the vertex pairs with
// global i < j, both valid, and dx*dx + dy*dy < (2r)^2, as one int
// partial per (TILE, TILE) tile of the pair matrix; the wrapper sums the
// partials in a second pass.
//
// What bounds it: per-pair ALU work on the CUDA cores (two subtracts,
// two multiplies, one add, the compares).  The contraction dimension is
// 2, so a tensor-core |a|^2 + |b|^2 - 2ab form would round differently
// and buy nothing; the input is 9 bytes per vertex, negligible.
//
// Design: one block per tile.  Tiles wholly below the diagonal hold no
// i < j pair and write 0 without work (about half the grid).  A block
// stages the j tile's coordinates in shared memory; each of its 256
// threads owns two i's in registers and tests them against every j (the
// shared-memory reads are broadcasts).  d2 is formed with __fmul_rn and
// __fadd_rn: nvcc would otherwise contract it into an FMA, which rounds
// once where the reference rounds each product, and flips pairs that sit
// exactly at the threshold.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;
constexpr int kThreads = 256;
constexpr int kPerThread = kTile / kThreads;

__global__ void __launch_bounds__(kThreads)
occlusion_pairs_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const uint8_t* __restrict__ ok, int n_tiles,
                       float thresh, int32_t* __restrict__ partial) {
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ uint8_t s_ok[kTile];
  __shared__ int32_t w_cnt[kThreads / 32];

  const int bj = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t out = static_cast<size_t>(bi) * n_tiles + bj;
  if (bj < bi) {
    if (tid == 0) partial[out] = 0;
    return;
  }

  const int j_base = bj * kTile;
  for (int k = tid; k < kTile; k += kThreads) {
    s_x[k] = x[j_base + k];
    s_y[k] = y[j_base + k];
    s_ok[k] = ok[j_base + k];
  }
  int gi[kPerThread];
  float xi[kPerThread], yi[kPerThread];
  bool oki[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    gi[r] = bi * kTile + tid + r * kThreads;
    xi[r] = x[gi[r]];
    yi[r] = y[gi[r]];
    oki[r] = ok[gi[r]] != 0;
  }
  __syncthreads();

  int count = 0;
  for (int jj = 0; jj < kTile; ++jj) {
    const int gj = j_base + jj;
    const float xj = s_x[jj];
    const float yj = s_y[jj];
    const bool okj = s_ok[jj] != 0;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const float dx = xi[r] - xj;
      const float dy = yi[r] - yj;
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      count += (oki[r] & okj & (gi[r] < gj) & (d2 < thresh)) ? 1 : 0;
    }
  }

  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((tid & 31) == 0) w_cnt[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int w = 0; w < kThreads / 32; ++w) c += w_cnt[w];
    partial[out] = c;
  }
}

}  // namespace

// Plain C entry.  n is a multiple of 512 (the wrapper pads); partial is
// (n/512, n/512).  Launches on `stream` and returns cudaGetLastError().
extern "C" int occlusion_pairs_launch(const void* x, const void* y,
                                      const void* ok, int n, float thresh,
                                      void* partial, void* stream) {
  const int n_tiles = n / kTile;
  const dim3 grid(n_tiles, n_tiles);
  occlusion_pairs_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const uint8_t*>(ok), n_tiles, thresh,
      static_cast<int32_t*>(partial));
  return static_cast<int>(cudaGetLastError());
}
