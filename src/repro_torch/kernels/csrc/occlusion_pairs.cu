// Tiled all-pairs node-occlusion count for Hopper (sm_90a): exact N_c.
//
// Replaces the Pallas TPU kernel repro/kernels/occlusion_pairs.py
// (_occlusion_kernel / occlusion_count).  Counts the vertex pairs with
// global i < j, both valid, and dx*dx + dy*dy < (2r)^2, as one int
// partial per (TILE, TILE) tile on or above the diagonal of the pair
// matrix; the wrapper sums the partials in int64.  A row range restricts
// i to [row0, row1) (j > i anywhere): the row-sharded driver's share.
//
// What bounds it: per-pair ALU work on the CUDA cores: two subtracts,
// two multiplies, one add and the compare, plus the count (a select and
// half of a three-input add in the code ptxas makes of the masks below).
// The contraction dimension is 2 and each product must be rounded on its
// own, so tensor cores do not apply; the input is 9 bytes per vertex,
// negligible.  A j tile is 4 KB against 262,144 pair tests,
// so asynchronous copies (cp.async, TMA) would hide nothing: the one
// staging load per block is not on the critical path.
//
// Design:
// * A 1-D grid of the tiles with bi <= bj of a row range (the whole
//   matrix, or one rank's rows for the row-sharded driver), numbered as
//   row_tiles.cuh says: column by column (k = bj (bj + 1) / 2 + bi for the
//   whole matrix), so that neighbouring blocks share a j tile in L2.  No
//   block exists only to write 0.
// * A block stages its j tile as float2 in shared memory and its i's in
//   registers, eight per thread; one 8-byte broadcast load then serves
//   eight pairs.
// * An invalid vertex is loaded as NaN: d2 is NaN and d2 < t false, so
//   no pair needs a mask.  A valid vertex with a NaN or infinite
//   coordinate gives a NaN or infinite d2 in the reference too.
// * A block whose i tile or j tile holds no valid vertex writes 0 at
//   once, decided by __syncthreads_or over the flags it loaded (the
//   padding of a pow2-bucketed request sits in whole tiles at the end).
// * The i < j order is tested only on the diagonal tile, in a loop of
//   its own.  Off it, each compare gives a -1 / 0 mask (set.lt) and one
//   three-input add sums two of them into minus the count, which ran
//   faster on the card than a predicated add per pair.
// * d2 is formed with __fmul_rn and __fadd_rn: nvcc would otherwise
//   contract it into an FMA, which rounds once where the reference
//   rounds each product, and flips pairs that sit exactly at the
//   threshold.
// * bfloat16 coordinates (the kernels backend at precision="bfloat16"):
//   widened to float on load, which is exact, and the distance formed in
//   float as for float32 input.  That is what the reference computes on
//   this route: its wrapper casts the bfloat16 layout to float32 before
//   the Pallas kernel (repro/kernels/ops.py, occlusion_count_op).  The
//   input is then 5 bytes per vertex.
// * A tile partial is at most 512^2 = 262,144: int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_tiles.cuh"

namespace {

constexpr int kTile = 512;
constexpr int kThreads = 64;
constexpr int kPerThread = kTile / kThreads;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float dist2(float xi, float yi, float2 pj) {
  const float dx = xi - pj.x;
  const float dy = yi - pj.y;
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// -1 if a < b, else 0 (also when either is NaN)
__device__ __forceinline__ int lt_mask(float a, float b) {
  int m;
  asm("set.lt.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(a), "f"(b));
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
occlusion_pairs_kernel(const T* __restrict__ x,
                       const T* __restrict__ y,
                       const uint8_t* __restrict__ ok, int t0, int m,
                       float thresh, int32_t* __restrict__ partial) {
  __shared__ float2 s_xy[kTile];
  __shared__ int32_t w_cnt[kThreads / 32];

  // tile k of the row range -> (bi, bj), bi <= bj
  const long long k = blockIdx.x;
  int bi, bj;
  row_tiles::tile(k, t0, m, bi, bj);
  const int tid = threadIdx.x;
  const float nan = __int_as_float(0x7fc00000);

  bool any_j = false;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int s = tid + r * kThreads;
    const int g = bj * kTile + s;
    const bool o = ok[g] != 0;
    any_j |= o;
    s_xy[s] = o ? make_float2(widen(x[g]), widen(y[g]))
                : make_float2(nan, nan);
  }
  float xi[kPerThread], yi[kPerThread];
  bool any_i = false;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int g = bi * kTile + tid + r * kThreads;
    const bool o = ok[g] != 0;
    any_i |= o;
    xi[r] = o ? widen(x[g]) : nan;
    yi[r] = o ? widen(y[g]) : nan;
  }
  const int has_i = __syncthreads_or(any_i);
  const int has_j = __syncthreads_or(any_j);  // also publishes s_xy
  if (!(has_i && has_j)) {
    if (tid == 0) partial[k] = 0;
    return;
  }

  int count = 0;
  if (bi != bj) {
    // minus the count, as pairs of -1 masks summed by one three-input add
    int neg[kPerThread / 2];
#pragma unroll
    for (int r = 0; r < kPerThread / 2; ++r) neg[r] = 0;
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      const float2 pj = s_xy[jj];
#pragma unroll
      for (int r = 0; r < kPerThread; r += 2)
        neg[r / 2] += lt_mask(dist2(xi[r], yi[r], pj), thresh) +
                      lt_mask(dist2(xi[r + 1], yi[r + 1], pj), thresh);
    }
#pragma unroll
    for (int r = 0; r < kPerThread / 2; ++r) count -= neg[r];
  } else {
    // diagonal tile: local i < local j, i = tid + r * kThreads
    int cnt[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) cnt[r] = 0;
#pragma unroll 2
    for (int jj = 0; jj < kTile; ++jj) {
      const float2 pj = s_xy[jj];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r)
        cnt[r] += (tid + r * kThreads < jj) & (dist2(xi[r], yi[r], pj) < thresh);
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) count += cnt[r];
  }

  // fixed-order block reduction: warp shuffle tree, then thread 0 adds
  // the warp partials in warp order
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((tid & 31) == 0) w_cnt[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int w = 0; w < kThreads / 32; ++w) c += w_cnt[w];
    partial[k] = c;
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* ok, int n, int row0,
           int row1, float thresh, void* partial, void* stream) {
  int t0, m;
  if (n % kTile || !row_tiles::split(n, row0, row1, kTile, t0, m))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = row_tiles::count(n / kTile, t0, m);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  occlusion_pairs_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const uint8_t*>(ok), t0, m, thresh,
      static_cast<int32_t*>(partial));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, x and y float32 (occlusion_pairs_launch) or bfloat16
// (occlusion_pairs_bf16_launch).  n is a multiple of 512 (the wrapper
// pads); the pairs counted are those with i in [row0, row1) and j > i,
// both ends multiples of 512 ([0, n) for the whole matrix).  partial
// holds one int32 per tile of the row range, row_tiles::count(n_t, t0, m)
// of them (n_t (n_t + 1) / 2 for the whole matrix), n_t = n / 512.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a bad row range.
extern "C" int occlusion_pairs_launch(const void* x, const void* y,
                                      const void* ok, int n, int row0,
                                      int row1, float thresh, void* partial,
                                      void* stream) {
  return launch<float>(x, y, ok, n, row0, row1, thresh, partial, stream);
}

extern "C" int occlusion_pairs_bf16_launch(const void* x, const void* y,
                                           const void* ok, int n, int row0,
                                           int row1, float thresh,
                                           void* partial, void* stream) {
  return launch<__nv_bfloat16>(x, y, ok, n, row0, row1, thresh, partial,
                               stream);
}
