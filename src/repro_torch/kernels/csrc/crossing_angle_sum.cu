// Tiled all-pairs crossing count and crossing-angle deviation sum for
// Hopper (sm_90a): exact E_ca.
//
// Replaces the Pallas TPU kernel repro/kernels/crossing_angle_sum.py
// (_angle_kernel / crossing_angle_stats): per (256, 256) tile on or above
// the diagonal of the edge-pair matrix (or of one row range of it), the int count of the crossing
// pairs (as in segment_crossing.cu) and the f32 sum of |ideal - a_c| *
// recip over them, `recip` the float32 rounding of 1 / ideal (the Pallas
// kernel's form).  The wrapper sums the partials in int64 / float64.  The
// sweep, its rounding, its bound and its design are in segment_pairs.cuh.
#include "segment_pairs.cuh"

// i's per thread and j loop unroll: the fastest on the card (PERF.md)
#ifndef SEGMENT_PAIRS_PER_THREAD
#define SEGMENT_PAIRS_PER_THREAD 8
#endif
#ifndef SEGMENT_PAIRS_UNROLL
#define SEGMENT_PAIRS_UNROLL 1
#endif

// Plain C entry.  n is a multiple of 256 (the wrapper pads); cnt_out and
// dev_out are (n_t (n_t + 1) / 2,) int32 / float32, n_t = n / 256, one
// partial per tile with bi <= bj.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int crossing_angle_sum_launch(const void* x1, const void* y1,
                                         const void* x2, const void* y2,
                                         const void* th, const void* v,
                                         const void* u, const void* ok,
                                         int n, float ideal, float recip,
                                         void* cnt_out, void* dev_out,
                                         void* stream) {
  return segment_pairs::launch_pair_sweep<true, SEGMENT_PAIRS_PER_THREAD,
                                          SEGMENT_PAIRS_UNROLL>(
      x1, y1, x2, y2, th, v, u, ok, n, 0, n, ideal, recip, cnt_out,
      dev_out, stream);
}

// The same sweep over the pairs with i in [row0, row1) and j > i, both
// ends multiples of 256 (the row-sharded driver gives each rank its
// rows); cnt_out and dev_out hold one partial per tile of the row range,
// row_tiles::count(n_t, row0 / 256, (row1 - row0) / 256) of them.
extern "C" int crossing_angle_sum_rows_launch(
    const void* x1, const void* y1, const void* x2, const void* y2,
    const void* th, const void* v, const void* u, const void* ok, int n,
    int row0, int row1, float ideal, float recip, void* cnt_out,
    void* dev_out, void* stream) {
  return segment_pairs::launch_pair_sweep<true, SEGMENT_PAIRS_PER_THREAD,
                                          SEGMENT_PAIRS_UNROLL>(
      x1, y1, x2, y2, th, v, u, ok, n, row0, row1, ideal, recip, cnt_out,
      dev_out, stream);
}
