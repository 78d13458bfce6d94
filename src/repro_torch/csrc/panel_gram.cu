// Panel Gram of the distributed CholeskyQR2 oracle, for Hopper.
//
// Replaces the TPU kernel panel_gram_kernel
// (repro/kernels/panel_gram/kernel.py), which keeps the candidate panel C
// (l x b) resident in VMEM across slabs and, in one pass over the local
// residual shard Z (l x n), emits
//   G = C^H C   (b x b)   on grid step 0 only,
//   V = C^H Z   (b x n)   one slab per grid step.
//
// Here one launch of 1 + ceil(n / 32) CTAs: CTA 0 computes G (each element
// one thread's sum over l in order; it is scheduled first, so its
// O(l b^2) work overlaps the slabs), and CTA 1 + s computes V for the
// 32-column slab s with pass 1 of the panel sweep (panel_common.cuh): C and
// Z staged through shared memory in 32-row chunks, V accumulated in
// registers, a ragged last slab masked.  Fixed summation order, no atomics.
//
// Bound at the gram path's shape (f64, l=800, b=32, n=2^14): about 109 MB
// (Z in, V out) for 0.84 GFLOP, so bytes.
#include "panel_common.cuh"

namespace {

using namespace repro;

template <class T>
__global__ void __launch_bounds__(kSweepThreads)
panel_gram_kernel(const T* __restrict__ c, const T* __restrict__ z,
                  T* __restrict__ g, T* __restrict__ v, int64_t l, int b, int64_t n) {
  if (blockIdx.x == 0) {
    gram(c, g, l, b);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // kSweepRows x b
  T* zs = cs + kSweepRows * b;             // kSweepRows x kSweepCols
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x - 1) * kSweepCols;
  const int64_t col = c0 + lane;
  T acc[kPerWarp];
  coeff_pass(c, z, l, b, n, c0, cs, zs, acc);
  if (col >= n) return;
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const int p = warp + kSweepWarps * q;
    if (p < b) v[p * n + col] = acc[q];
  }
}

// Returns the launch's status, a refused shared-memory request's included.
template <class T>
cudaError_t launch_gram(const void* c, const void* z, void* g, void* v, int64_t l, int b,
                        int64_t n, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(kSweepRows) * b +
                                   kSweepRows * kSweepCols);
  const unsigned grid = 1 + static_cast<unsigned>((n + kSweepCols - 1) / kSweepCols);
  return launch(panel_gram_kernel<T>, dim3(grid), dim3(kSweepThreads), smem, stream,
                static_cast<const T*>(c), static_cast<const T*>(z), static_cast<T*>(g),
                static_cast<T*>(v), l, b, n);
}

}  // namespace

extern "C" int repro_panel_gram(int dtype, const void* c, const void* z, void* g,
                                void* v, int64_t l, int64_t b, int64_t n,
                                void* stream) {
  if (l < 0 || n < 0 || b < 1 || b > repro::kMaxPanel)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_gram, c, z, g, v, l, static_cast<int>(b), n, s);
}
