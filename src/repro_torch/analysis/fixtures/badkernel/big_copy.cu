// big_copy: the kernel of the analysis fixture "badkernel", for Hopper.
//
// Replaces the TPU kernel big_copy_kernel
// (repro/analysis/fixtures/badkernel/kernel.py), a copy o = x whose grid
// walks column blocks of bn and whose input block is the WHOLE (m, n)
// operand on every grid step: the VMEM-hostile blocking that the
// reference's kernel checker must flag.
//
// The same hostile blocking here: one CTA per column block of bn; each CTA
// stages the whole operand in dynamic shared memory (m * n * sizeof(T)
// bytes), synchronizes, and writes its (m, bn) block of o from shared
// memory.  Where the operand fits one block's shared memory (232448 B on
// Hopper) it copies exactly; at the contract's example, 4096 x 4096 f32 =
// 64 MiB, the shared-memory request is refused and the entry point returns
// that status without launching (common.cuh, launch).
//
// It is built into a library of its own (kernels/_build.py, load_extra),
// never into the production one.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;

template <class T>
__global__ void __launch_bounds__(kThreads)
big_copy_kernel(const T* __restrict__ x, T* __restrict__ o, int64_t m, int64_t n,
                int64_t bn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // the whole (m, n) operand
  const int64_t total = m * n;
  for (int64_t e = threadIdx.x; e < total; e += blockDim.x) xs[e] = x[e];
  __syncthreads();
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * bn;
  const int64_t w = (n - c0 < bn) ? n - c0 : bn;
  for (int64_t e = threadIdx.x; e < m * w; e += blockDim.x) {
    const int64_t idx = (e / w) * n + c0 + e % w;
    o[idx] = xs[idx];
  }
}

template <class T>
cudaError_t launch_big_copy(const void* x, void* o, int64_t m, int64_t n, int64_t bn,
                            cudaStream_t stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(m) * static_cast<size_t>(n);
  const unsigned grid = static_cast<unsigned>((n + bn - 1) / bn);
  return launch(big_copy_kernel<T>, dim3(grid), dim3(kThreads), smem, stream,
                static_cast<const T*>(x), static_cast<T*>(o), m, n, bn);
}

}  // namespace

// x and o (m, n), row-major, of the element type `dtype` (common.cuh).
extern "C" int repro_big_copy(int dtype, const void* x, void* o, int64_t m, int64_t n,
                              int64_t bn, void* stream) {
  if (m < 1 || n < 1 || bn < 1 || (n + bn - 1) / bn > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_big_copy, x, o, m, n, bn, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

REPRO_QUERY_ENTRIES
