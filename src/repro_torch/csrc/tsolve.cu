// Column-parallel blocked triangular solve for Hopper: T with
// triu(R1) @ T = R2 (paper eq. 10), R1 (k, k), R2 and T (k, n).
//
// Replaces the TPU kernel tsolve_kernel (repro/kernels/tsolve/kernel.py),
// whose grid walks 128-column slabs of R2 with R1 and the slab resident in
// VMEM, solving row blocks bottom-up: a (bk x k) @ (k x bn) trailing
// update, then bk sequential rows of the diagonal block.
//
// Every column solves independently (the paper's one processor per
// column), so one CTA owns a slab of kCols columns and walks the row
// blocks of kRows rows from the bottom:
//   * trailing update: b = R2[blk] - R1[blk, below] @ T[below], with R1's
//     band and the already solved rows of T (read back from the output,
//     written by this CTA) staged through shared memory kTJ rows at a time;
//   * diagonal block: row by row from the bottom, t_i = b_i / R1[i, i]
//     (the raw diagonal: no clamp, as in the TPU kernel), then every row
//     above subtracts R1[r, i] t_i in parallel, one barrier per row.
// Only the upper triangle of R1 is read.  k is masked, never padded.  The
// shared memory is fixed (the b block and two staging tiles, at most 33 KB
// for complex128) whatever k is: T lives in the output, not on chip.
//
// Bound: k^2 n flop against (k^2 + 2 k n) elements; at the paper's row
// k=400, n=2^14 in f64, 2.6e9 flop and 1.06e8 bytes, bound by operations
// (0.039 ms at 67 TFLOP/s).  This simple form is held back by the k
// barriers of the diagonal blocks and by the CUDA-core FMAs of the
// trailing update.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kCols = 32;                  // columns per CTA (threadIdx.x)
constexpr int kRowGroups = 8;              // threadIdx.y
constexpr int kRows = 32;                  // rows per block
constexpr int kRowsPerThread = kRows / kRowGroups;
constexpr int kTJ = 16;                    // rows of T per staging tile

__device__ __forceinline__ float solve_div(float a, float d) { return a / d; }
__device__ __forceinline__ double solve_div(double a, double d) { return a / d; }
template <class R>
__device__ __forceinline__ cplx<R> solve_div(cplx<R> a, cplx<R> d) {
  const R den = abs2_add(d, R(0));
  return div_r(a * conj_of(d), den);
}

template <class T>
__global__ void __launch_bounds__(kCols * kRowGroups)
tsolve_kernel(const T* __restrict__ r1, const T* __restrict__ r2,
              T* __restrict__ t, int64_t k, int64_t n) {
  __shared__ T rt[kRows][kTJ + 1];
  __shared__ T tt[kTJ][kCols];
  __shared__ T bs[kRows][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kCols + tx;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int64_t nblk = (k + kRows - 1) / kRows;

  for (int64_t bi = nblk - 1; bi >= 0; --bi) {
    const int64_t r0 = bi * kRows;
    const int64_t rend = (r0 + kRows < k) ? r0 + kRows : k;
    const int nr = static_cast<int>(rend - r0);

    T acc[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[q] = T{};
    for (int64_t j0 = rend; j0 < k; j0 += kTJ) {
      for (int e = tid; e < kRows * kTJ; e += kCols * kRowGroups) {
        const int r = e / kTJ, jj = e % kTJ;
        rt[r][jj] = (r < nr && j0 + jj < k) ? r1[(r0 + r) * k + j0 + jj] : T{};
      }
      for (int e = tid; e < kTJ * kCols; e += kCols * kRowGroups) {
        const int jj = e / kCols, c = e % kCols;
        tt[jj][c] = (j0 + jj < k && col0 + c < n) ? t[(j0 + jj) * n + col0 + c]
                                                  : T{};
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj) {
        const T tv = tt[jj][tx];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
          acc[q] = madd(rt[ty + kRowGroups * q][jj], tv, acc[q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int r = ty + kRowGroups * q;
      bs[r][tx] = (r < nr && col < n) ? r2[(r0 + r) * n + col] - acc[q] : T{};
    }
    __syncthreads();

    for (int i = nr - 1; i >= 0; --i) {
      const T ti = solve_div(bs[i][tx], r1[(r0 + i) * k + r0 + i]);
      if (ty == 0 && col < n) t[(r0 + i) * n + col] = ti;
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int r = ty + kRowGroups * q;
        if (r < i) bs[r][tx] = bs[r][tx] - r1[(r0 + r) * k + r0 + i] * ti;
      }
      __syncthreads();
    }
  }
}

template <class T>
cudaError_t launch_tsolve(const void* r1, const void* r2, void* t, int64_t k,
                          int64_t n, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kCols - 1) / kCols));
  return launch(tsolve_kernel<T>, grid, dim3(kCols, kRowGroups), 0, stream,
                static_cast<const T*>(r1), static_cast<const T*>(r2),
                static_cast<T*>(t), k, n);
}

}  // namespace

extern "C" int repro_tsolve(int dtype, const void* r1, const void* r2,
                            void* t, int64_t k, int64_t n, void* stream) {
  if (k <= 0 || n <= 0 || (n + kCols - 1) / kCols > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_tsolve, r1, r2, t, k, n, s);
}
