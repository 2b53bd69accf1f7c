// Per-row strip-reversal sweep for Hopper (sm_90a): the edge-crossing
// count and the crossing-angle deviation sum of every strip bucket.
//
// Replaces the Pallas TPU kernel repro/kernels/strip_reversal.py
// (_reversal_kernel / strip_reversal_stats).  For each row of a
// (rows, cap) slab it counts the pairs with
//     yl_i < yl_j  &&  yr_i > yr_j,  no shared endpoint, both valid
// and, with_angle, sums |ideal - min(d, pi - d)| / ideal, d = |th_i - th_j|,
// over the same pairs -- by true (IEEE) division, as the reference does.
//
// What bounds the function: per-pair ALU work on the CUDA cores -- four
// float compares and the join that decide a reversal in either order.
// The function needs the shared-endpoint compares only on reversing
// pairs, the count and the deviation only on crossings (34,534 against
// about 4e8 pairs on the main path).  The input is 21 bytes per
// slot, negligible next to the pair tests; no matrix product, so no
// tensor-core work.
//
// Design:
// * Extent.  A row's extent is its last valid slot + 1, found by the
//   block (a warp max reduction, then a shared atomicMax per warp) in the
//   same pass that stages the row, with all its loads issued together.
//   Only slots below it are swept.  Valid slots need not form a
//   prefix: invalid ones inside the extent are staged with yl = NaN, so
//   that every compare of the reversal test is false and no pair needs a
//   mask.
// * Unordered pairs.  Each pair i < j is tested once, in both
//   orientations, (yl_i < yl_j & yr_i > yr_j) | (yl_j < yl_i & yr_j > yr_i):
//   half the work of sweeping ordered pairs.  Ties and NaN give no
//   reversal either way, as in the reference.
// * Staging.  The row is staged once in shared memory as one 16-byte
//   record per slot (yl, yr, v, u), read as one broadcast load per j,
//   and theta beside it, read only under the reversal branch.
// * Work split.  The row's upper triangle is cut into items: 64 i's (a
//   chunk, two per lane in registers) against 32 j's (a j tile).  The
//   items of a block's rows are numbered in order and every warp takes a
//   contiguous run of them, so that the warps share the triangle evenly
//   and a warp reloads its i's only when the chunk changes.  Items on the
//   diagonal test the i < j order in a loop of their own.
// * Short rows.  A block takes several rows of a short slab (as many as
//   fit in 512 staged slots, at most 8; the entry works this out from
//   cap) and numbers the items of all of them, so that a block on a
//   short slab is not mostly idle.
// * Long rows.  A row of more than 1024 slots is swept in windows of
//   1024 slots: for every pair of windows A <= B, window A and window B
//   are staged (40 KB) and their triangle (A == B) or rectangle swept.
// * Rare work under a branch.  Per pair only the reversal test runs; the
//   shared-endpoint test, the count and the deviation run under a branch
//   taken by the lanes whose pair reverses.
// * Tuning: chosen by one-off comparisons of variants on the card at the
//   main path's slabs, with a harness that was not kept: two i's per
//   lane against four, the j loop unrolled 4 times against fully, a
//   row's items split over several blocks, and a warp-uniform branch
//   with a queue of crossings for the deviations.  Re-time them before
//   relying on these choices.
// * Outputs: one int64 count and one f32 deviation per row.  Each lane
//   sums in int32 / f32 within one item run; a fixed-order warp shuffle
//   tree and per-warp, per-row double partials in shared memory, summed
//   in warp order, give the row's values.  No atomics touch the sums, so
//   the deviation is the same from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 2;              // i's per lane
constexpr int kChunk = 32 * kPerLane;    // i's per item
constexpr int kJTile = 32;               // j's per item
constexpr int kWindow = 1024;            // slots staged per block or window
constexpr int kMaxRows = kWarps;         // rows per block, at most
constexpr int kPack = 512;               // slots a block of short rows stages
// pi as the reference's f32 expression rounds it
constexpr float kPi = 3.14159265358979f;

struct alignas(16) Rec {
  float yl, yr;
  int32_t v, u;
};

// one unit of sweep: the pairs of slots [0, len_i) of region ri against
// [0, len_j) of region rj (tri: the pairs i < j of one region)
struct Job {
  int row;      // local row of the block
  int len_i, len_j;
  int ri, rj;   // shared-memory regions
  bool tri;
};

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int job_items(const Job& j) {
  if (j.tri) {
    if (j.len_i < 2) return 0;
    const int nc = ceil_div(j.len_i, kChunk), nt = ceil_div(j.len_i, kJTile);
    return nc * nt - kPerLane * nc * (nc - 1) / 2;
  }
  if (j.len_i < 1 || j.len_j < 1) return 0;
  return ceil_div(j.len_i, kChunk) * ceil_div(j.len_j, kJTile);
}

// item -> (chunk a, j tile t) within a job
__device__ __forceinline__ void item_at(const Job& j, int idx, int& a,
                                        int& t) {
  const int nt = ceil_div(j.len_j, kJTile);
  if (!j.tri) {
    a = idx / nt;
    t = idx - a * nt;
    return;
  }
  a = 0;
  while (idx >= nt - a * kPerLane) {
    idx -= nt - a * kPerLane;
    ++a;
  }
  t = a * kPerLane + idx;
}

__device__ __forceinline__ Rec nan_rec() {
  Rec r;
  r.yl = __int_as_float(0x7fc00000);
  r.yr = 0.f;
  r.v = -1;
  r.u = -1;
  return r;
}

// (yl_i < yl_j & yr_i > yr_j) | (yl_j < yl_i & yr_j > yr_i); false on
// ties and whenever an ordinate is NaN
__device__ __forceinline__ bool reverses(float yli, float yri, const Rec& q) {
  return ((yli < q.yl) & (yri > q.yr)) | ((q.yl < yli) & (q.yr > yri));
}

// no endpoint of segment i is one of slot q's
__device__ __forceinline__ bool disjoint(int32_t vi, int32_t ui,
                                         const Rec& q) {
  return (vi != q.v) & (vi != q.u) & (ui != q.v) & (ui != q.u);
}

// |ideal - min(d, pi - d)| / ideal, d = |th_i - th_j|, by IEEE division
__device__ __forceinline__ float deviation(float thi, float thj,
                                           float ideal) {
  const float d = fabsf(thi - thj);
  const float a_c = fminf(d, kPi - d);
  return fabsf(ideal - a_c) / ideal;
}

template <bool kWithAngle>
__global__ void __launch_bounds__(kThreads)
strip_reversal_kernel(const float* __restrict__ yl,
                      const float* __restrict__ yr,
                      const float* __restrict__ th,
                      const int32_t* __restrict__ v,
                      const int32_t* __restrict__ u,
                      const uint8_t* __restrict__ ok, int rows, int cap,
                      int stride, int rows_per_block, float ideal,
                      long long* __restrict__ cnt_out,
                      float* __restrict__ dev_out) {
  extern __shared__ Rec s_rec[];
  __shared__ int s_ext[kMaxRows];
  __shared__ long long s_cnt[kWarps][kMaxRows];
  __shared__ double s_dev[kWarps][kMaxRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, rows - row0);
  const bool windowed = cap > kWindow;
  const int n_slots = windowed ? 2 * kWindow : rows_per_block * stride;
  float* s_th = reinterpret_cast<float*>(s_rec + n_slots);
  if (tid < kMaxRows) s_ext[tid] = 0;
  if (tid < kWarps * kMaxRows) {
    s_cnt[tid / kMaxRows][tid % kMaxRows] = 0;
    s_dev[tid / kMaxRows][tid % kMaxRows] = 0.0;
  }
  __syncthreads();

  if (!windowed) {
    // one pass over the staged slots (all loads issued together): stage
    // them and find each row's extent, last valid slot + 1.  The stride
    // is a multiple of 32, so the 32 slots of a warp lie in one row.
    constexpr int kSlots = kWindow / kThreads;
    Rec rec[kSlots];
    float thv[kSlots];
    bool okv[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int e = tid + q * kThreads;
      const int rr = e / stride, s = e - rr * stride;
      okv[q] = false;
      rec[q] = nan_rec();
      thv[q] = 0.f;
      if (e < nr * stride && s < cap) {
        const size_t g = static_cast<size_t>(row0 + rr) * cap + s;
        okv[q] = ok[g] != 0;
        rec[q] = Rec{yl[g], yr[g], v[g], u[g]};
        thv[q] = th[g];
      }
    }
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int e = tid + q * kThreads;
      if (e - lane >= nr * stride) break;  // uniform over the warp
      if (!okv[q]) rec[q].yl = __int_as_float(0x7fc00000);
      s_rec[e] = rec[q];
      s_th[e] = thv[q];
      const int rr = (e - lane) / stride;
      int last = okv[q] ? e - rr * stride + 1 : 0;
      last = __reduce_max_sync(0xffffffffu, last);
      if (lane == 0 && last > 0) atomicMax(&s_ext[rr], last);
    }
  } else {
    // extent of the one row, then a staging pass per pair of windows
    const size_t base = static_cast<size_t>(row0) * cap;
    int last = 0;
    for (int s = tid; s < cap; s += kThreads)
      if (ok[base + s] != 0) last = s + 1;
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0 && last > 0) atomicMax(&s_ext[0], last);
  }
  __syncthreads();

  const int n_win = windowed ? ceil_div(s_ext[0], kWindow) : 1;
  for (int wa = 0; wa < n_win; ++wa) {
    for (int wb = wa; wb < n_win; ++wb) {
      auto job_of = [&](int jb) {
        Job j;
        if (!windowed) {
          j.row = jb;
          j.len_i = j.len_j = s_ext[jb];
          j.ri = j.rj = jb;
          j.tri = true;
        } else {
          const int ext = s_ext[0];
          j.row = 0;
          j.len_i = min(kWindow, ext - wa * kWindow);
          j.len_j = min(kWindow, ext - wb * kWindow);
          j.ri = 0;
          j.rj = wa == wb ? 0 : 1;
          j.tri = wa == wb;
        }
        return j;
      };
      const int n_jobs = windowed ? 1 : nr;
      int total = 0;
      for (int jb = 0; jb < n_jobs; ++jb) total += job_items(job_of(jb));
      if (total == 0) continue;  // uniform over the block
      // this warp's run of the items
      const int per_warp = ceil_div(total, kWarps);
      int it = warp * per_warp;
      const int it_end = min(total, it + per_warp);

      if (windowed) {
        // stage windows wa and wb of the block's one row; slots from the
        // extent up to the next j tile are NaN records
        const size_t base = static_cast<size_t>(row0) * cap;
        for (int w = 0; w < (wa == wb ? 1 : 2); ++w) {
          const int off = (w == 0 ? wa : wb) * kWindow;
          const int len = min(kWindow, s_ext[0] - off);
          const int end = ceil_div(len, kJTile) * kJTile;
          for (int s = tid; s < end; s += kThreads) {
            const size_t g = base + off + s;
            if (s < len) {
              s_rec[w * kWindow + s] =
                  Rec{ok[g] != 0 ? yl[g] : __int_as_float(0x7fc00000), yr[g],
                      v[g], u[g]};
              s_th[w * kWindow + s] = th[g];
            } else {
              s_rec[w * kWindow + s] = nan_rec();
            }
          }
        }
        __syncthreads();
      }

      if (it < it_end) {
        // locate the first item of this warp's run
        int jb = 0, rest = it;
        Job job = job_of(0);
        for (int n = job_items(job); rest >= n; n = job_items(job)) {
          rest -= n;
          job = job_of(++jb);
        }
        int a, t;
        item_at(job, rest, a, t);
        int loaded = -1;
        float yli[kPerLane], yri[kPerLane];
        int32_t vi[kPerLane], ui[kPerLane];
        int count = 0;
        float dev = 0.f;
        for (; it < it_end; ++it) {
          const Rec* ri = s_rec + job.ri * stride;
          const Rec* rj = s_rec + job.rj * stride;
          const float* ti = s_th + job.ri * stride;
          const float* tj = s_th + job.rj * stride;
          const int i0 = a * kChunk + lane;
          if (a != loaded) {
#pragma unroll
            for (int r = 0; r < kPerLane; ++r) {
              const Rec q = i0 + 32 * r < job.len_i ? ri[i0 + 32 * r]
                                                    : nan_rec();
              yli[r] = q.yl;
              yri[r] = q.yr;
              vi[r] = q.v;
              ui[r] = q.u;
            }
            loaded = a;
          }
          const int j0 = t * kJTile;
          const Rec* rq = rj + j0;
          // the lane's pairs with slot j0 + k: only the reversal test on
          // every pair, the rest under a branch
          auto sweep = [&](int k, bool diag) {
            const Rec q = rq[k];
            bool rv[kPerLane];
            bool any = false;
#pragma unroll
            for (int r = 0; r < kPerLane; ++r) {
              rv[r] = reverses(yli[r], yri[r], q);
              if (diag) rv[r] &= i0 + 32 * r < j0 + k;
              any |= rv[r];
            }
            if (any) {
#pragma unroll
              for (int r = 0; r < kPerLane; ++r)
                if (rv[r] && disjoint(vi[r], ui[r], q)) {
                  ++count;
                  if (kWithAngle)
                    dev += deviation(ti[i0 + 32 * r], tj[j0 + k], ideal);
                }
            }
          };
          if (!job.tri || t >= (a + 1) * kPerLane) {
#pragma unroll 4
            for (int k = 0; k < kJTile; ++k) sweep(k, false);
          } else {
            // j tile on the diagonal: only i < j
#pragma unroll 4
            for (int k = 0; k < kJTile; ++k) sweep(k, true);
          }

          // next item; flush the run's sums when the job changes or ends
          const int nt = ceil_div(job.len_j, kJTile);
          if (++t == nt) {
            ++a;
            t = job.tri ? a * kPerLane : 0;
          }
          const bool job_done = a == ceil_div(job.len_i, kChunk);
          if (job_done || it + 1 == it_end) {
            for (int off = 16; off > 0; off >>= 1) {
              count += __shfl_down_sync(0xffffffffu, count, off);
              if (kWithAngle) dev += __shfl_down_sync(0xffffffffu, dev, off);
            }
            if (lane == 0) {
              s_cnt[warp][job.row] += count;
              if (kWithAngle) s_dev[warp][job.row] += static_cast<double>(dev);
            }
            count = 0;
            dev = 0.f;
          }
          if (job_done && it + 1 < it_end) {
            do {
              job = job_of(++jb);
            } while (job_items(job) == 0);
            a = 0;
            t = 0;
            loaded = -1;
          }
        }
      }
      if (windowed) __syncthreads();
    }
  }
  __syncthreads();

  // per-row sums over the warps, in warp order
  if (tid < nr) {
    long long c = 0;
    double d = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      c += s_cnt[w][tid];
      d += s_dev[w][tid];
    }
    cnt_out[row0 + tid] = c;
    dev_out[row0 + tid] = static_cast<float>(d);
  }
}

}  // namespace

// Plain C entry.  Sweeps a (rows, cap) slab, any cap.  Rows of at most
// 1024 slots are packed several to a block, as many as fit in 512 staged
// slots (each row rounded up to 32) and at most kMaxRows; longer rows
// take a block each.  cnt_out is (rows,) int64, dev_out (rows,) f32 (0
// unless with_angle).  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty slab.
extern "C" int strip_reversal_launch(const void* yl, const void* yr,
                                     const void* th, const void* v,
                                     const void* u, const void* ok, int rows,
                                     int cap, float ideal, int with_angle,
                                     void* cnt_out, void* dev_out,
                                     void* stream) {
  if (rows < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool windowed = cap > kWindow;
  const int stride = windowed ? kWindow : (cap + kJTile - 1) / kJTile * kJTile;
  const int rows_per_block =
      windowed ? 1 : std::max(1, std::min(kMaxRows, kPack / stride));
  const int n_slots = windowed ? 2 * kWindow : rows_per_block * stride;
  const size_t smem = (sizeof(Rec) + sizeof(float)) * n_slots;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_yl = static_cast<const float*>(yl);
  const float* f_yr = static_cast<const float*>(yr);
  const float* f_th = static_cast<const float*>(th);
  const int32_t* i_v = static_cast<const int32_t*>(v);
  const int32_t* i_u = static_cast<const int32_t*>(u);
  const uint8_t* b_ok = static_cast<const uint8_t*>(ok);
  long long* o_cnt = static_cast<long long*>(cnt_out);
  float* o_dev = static_cast<float*>(dev_out);
  if (with_angle) {
    strip_reversal_kernel<true><<<blocks, kThreads, smem, s>>>(
        f_yl, f_yr, f_th, i_v, i_u, b_ok, rows, cap, stride, rows_per_block,
        ideal, o_cnt, o_dev);
  } else {
    strip_reversal_kernel<false><<<blocks, kThreads, smem, s>>>(
        f_yl, f_yr, f_th, i_v, i_u, b_ok, rows, cap, stride, rows_per_block,
        ideal, o_cnt, o_dev);
  }
  return static_cast<int>(cudaGetLastError());
}
