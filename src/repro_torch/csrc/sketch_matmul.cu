// Sketch GEMM for Hopper: Y = omega @ a, one running sum over all of m.
//
// Replaces the TPU kernel sketch_matmul_kernel
// (repro/kernels/sketch_matmul/kernel.py), whose grid (l/bl, n/bn, m/bk)
// walks k innermost, adding each bk-row product into an output tile kept
// in VMEM scratch and writing it back once.
//
// On Hopper the innermost grid dimension becomes a loop inside each CTA:
//   * the grid covers (l, n) output tiles; a CTA walks m in order in
//     shared-memory stages of kGemmBK rows (gemm_tile.cuh) and stores its
//     tile once;
//   * one running sum per output element, no split-K, no atomics, so the
//     result is deterministic (it differs from sketch_accum, which sums
//     each 128-row block from zero before adding it);
//   * complex types are multiplied in complex arithmetic in this one
//     launch (the TPU wrapper runs four real GEMMs);
//   * ragged l, m and n are masked in the kernel: a is never padded or
//     copied.
// The accumulator is the element type itself: FFMA/DFMA, never TF32.
//
// Bound: at the paper's row k=400, m=2^16, n=2^14 in f64 the work is
// 2 l m n = 1.7e12 flop against ~9.1e9 bytes, bound by operations.  This
// is the simple register-tiled form shared with sketch_accum; a wgmma/TMA
// pipeline is later work.
#include "gemm_tile.cuh"

namespace {

using namespace repro;

template <class T>
__global__ void __launch_bounds__(kGemmTX * kGemmTY)
sketch_matmul_kernel(const T* __restrict__ omega, const T* __restrict__ a,
                     T* __restrict__ out, int64_t l, int64_t m, int64_t n) {
  constexpr int TM = GemmShape<T>::TM, TN = GemmShape<T>::TN;
  __shared__ GemmSmem<T> sm;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * GemmShape<T>::BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * GemmShape<T>::BN;

  T run[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) run[i][j] = T{};
  gemm_tile_mac<T>(omega, a, l, m, n, row0, col0, 0, m, run, sm);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t r = row0 + ty + kGemmTY * i, c = col0 + tx + kGemmTX * j;
      if (r < l && c < n) out[r * n + c] = run[i][j];
    }
  }
}

template <class T>
cudaError_t launch_sketch_matmul(const void* omega, const void* a, void* out,
                                 int64_t l, int64_t m, int64_t n,
                                 cudaStream_t stream) {
  return launch(sketch_matmul_kernel<T>, gemm_grid<T>(l, n), dim3(kGemmTX, kGemmTY), 0,
                stream, static_cast<const T*>(omega), static_cast<const T*>(a),
                static_cast<T*>(out), l, m, n);
}

}  // namespace

extern "C" int repro_sketch_matmul(int dtype, const void* omega,
                                   const void* a, void* out, int64_t l,
                                   int64_t m, int64_t n, void* stream) {
  if (l <= 0 || n <= 0 || m < 0 || (l + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_sketch_matmul, omega, a, out, l, m, n, s);
}
