// The upper-triangle tiles of a row range, shared by the all-pairs sweeps
// (occlusion_pairs.cu and segment_pairs.cuh).
//
// The pair matrix of n items is cut into (T, T) tiles, n_t = n / T of them
// per side; a sweep counts the pairs i < j, so it visits the tiles
// (bi, bj) with bi <= bj.  A row range [t0, t0 + m) of row tiles (rows
// [t0 T, (t0 + m) T) of the matrix: the row-sharded drivers give each rank
// one) owns the tiles with t0 <= bi < t0 + m and bj >= bi, one block each:
//   * first the triangle of its own tiles, bi <= bj < t0 + m, numbered
//     column by column, k = c (c + 1) / 2 + r with bi = t0 + r,
//     bj = t0 + c, so that neighbouring blocks share a j tile in L2;
//   * then the rectangle of its rows against the column tiles past the
//     range, k = tri + (bj - t0 - m) m + (bi - t0).
// The full range (t0 = 0, m = n_t) is the triangle alone, numbered
// k = bj (bj + 1) / 2 + bi.
#pragma once

#include <math.h>

namespace row_tiles {

// number of tiles, hence blocks and partials, of the row range
inline long long count(long long n_t, long long t0, long long m) {
  return m * (m + 1) / 2 + (n_t - t0 - m) * m;
}

// tile k of the row range -> (bi, bj)
__device__ __forceinline__ void tile(long long k, int t0, int m, int& bi,
                                     int& bj) {
  const long long tri = static_cast<long long>(m) * (m + 1) / 2;
  if (k < tri) {
    int c = static_cast<int>((sqrt(8.0 * static_cast<double>(k) + 1.0) -
                              1.0) * 0.5);
    while (static_cast<long long>(c) * (c + 1) / 2 > k) --c;
    while (static_cast<long long>(c + 1) * (c + 2) / 2 <= k) ++c;
    bi = t0 + static_cast<int>(k - static_cast<long long>(c) * (c + 1) / 2);
    bj = t0 + c;
  } else {
    const long long r = k - tri;
    bj = t0 + m + static_cast<int>(r / m);
    bi = t0 + static_cast<int>(r % m);
  }
}

// the row range [row0, row1) of n items in tiles of T: false unless both
// ends are tile multiples with 0 <= row0 <= row1 <= n
inline bool split(int n, int row0, int row1, int T, int& t0, int& m) {
  if (row0 < 0 || row0 > row1 || row1 > n || row0 % T || row1 % T)
    return false;
  t0 = row0 / T;
  m = (row1 - row0) / T;
  return true;
}

}  // namespace row_tiles
