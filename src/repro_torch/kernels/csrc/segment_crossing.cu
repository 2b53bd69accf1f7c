// Tiled all-pairs edge-crossing count for Hopper (sm_90a): exact E_c.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_crossing.py
// (_crossing_kernel / _cross_tile / crossing_count): one int partial per
// (256, 256) tile on or above the diagonal of the edge-pair matrix,
// counting the pairs with global i < j, both valid, no shared endpoint
// and the CCW straddle test.  The wrapper sums the partials in int64.
// The sweep, its rounding, its bound and its design are in
// segment_pairs.cuh.
#include "segment_pairs.cuh"

// i's per thread and j loop unroll: the fastest on the card (PERF.md)
#ifndef SEGMENT_PAIRS_PER_THREAD
#define SEGMENT_PAIRS_PER_THREAD 8
#endif
#ifndef SEGMENT_PAIRS_UNROLL
#define SEGMENT_PAIRS_UNROLL 4
#endif

// Plain C entry.  n is a multiple of 256 (the wrapper pads); the pairs
// counted are those with i in [row0, row1) and j > i, both ends multiples
// of 256 ([0, n) for the whole matrix: the row-sharded driver gives each
// rank its rows).  partial holds one int32 per tile of the row range,
// row_tiles::count(n_t, t0, m) of them (n_t (n_t + 1) / 2 for the whole
// matrix), n_t = n / 256.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int segment_crossing_launch(const void* x1, const void* y1,
                                       const void* x2, const void* y2,
                                       const void* v, const void* u,
                                       const void* ok, int n, int row0,
                                       int row1, void* partial,
                                       void* stream) {
  return segment_pairs::launch_pair_sweep<false, SEGMENT_PAIRS_PER_THREAD,
                                          SEGMENT_PAIRS_UNROLL>(
      x1, y1, x2, y2, nullptr, v, u, ok, n, row0, row1, 1.f, 1.f, partial,
      nullptr, stream);
}
