// Pieces shared by the panel kernels (panel_step.cu, panel_gram.cu,
// panel_apply.cu, panel_deflate.cu): the tile constants of a column sweep
// and pass 1 of the re-reading sweep (coefficients X^H Z for one 32-column
// slab of Z).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kMaxPanel = 64;      // widest panel (MAX_PANEL in kernel.py)
constexpr int kSweepCols = 32;     // columns of Z per CTA: one per lane
constexpr int kSweepWarps = 8;
constexpr int kSweepRows = 32;     // rows of l per shared-memory chunk
constexpr int kSweepThreads = kSweepCols * kSweepWarps;
constexpr int kPerWarp = kMaxPanel / kSweepWarps;  // panel columns per warp

// Pass 1 of a sweep by a kSweepThreads block: acc[q] = sum_r conj(x[r, p])
// z[r, c0 + lane] for p = warp + kSweepWarps * q < b, summed over l in
// order, through shared-memory chunks xs (kSweepRows x b) and zs
// (kSweepRows x kSweepCols).  Columns past n read as zero.  Ends with a
// barrier, so xs and zs may be reused at once.
template <class T>
__device__ __forceinline__ void coeff_pass(const T* __restrict__ x, const T* __restrict__ z,
                           int64_t l, int b, int64_t n, int64_t c0, T* xs, T* zs,
                           T (&acc)[kPerWarp]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) acc[q] = T{};
  for (int64_t r0 = 0; r0 < l; r0 += kSweepRows) {
    const int rows = static_cast<int>((l - r0 < kSweepRows) ? l - r0 : kSweepRows);
    for (int e = threadIdx.x; e < rows * b; e += blockDim.x)
      xs[e] = x[r0 * b + e];
    for (int e = threadIdx.x; e < rows * kSweepCols; e += blockDim.x) {
      const int rr = e / kSweepCols, cc = e % kSweepCols;
      zs[e] = (c0 + cc < n) ? z[(r0 + rr) * n + c0 + cc] : T{};
    }
    __syncthreads();
    for (int rr = 0; rr < rows; ++rr) {
      const T zv = zs[rr * kSweepCols + lane];
#pragma unroll
      for (int q = 0; q < kPerWarp; ++q) {
        const int p = warp + kSweepWarps * q;
        if (p < b) acc[q] = madd(conj_of(xs[rr * b + p]), zv, acc[q]);
      }
    }
    __syncthreads();
  }
}

}  // namespace repro
