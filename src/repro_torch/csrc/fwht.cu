// One sweep of the fast Walsh-Hadamard transform along dim 0 for Hopper.
//
// Replaces the TPU kernel fwht_kernel (repro/kernels/srht/kernel.py),
// which holds the full (m, 128)-column slab in VMEM (m <= 8192, a 4 MiB
// budget) and runs all log2(m) butterfly stages on it.
//
// A CTA has at most 227 KB of shared memory, and x is row-major (m, n), so
// the port splits m = f_1 * f_2 * ... into Kronecker factors of at most
// kMaxSlabRows rows and runs one launch (sweep) per factor, the low factor
// first.  A sweep with factor f and row stride s transforms, for every
// group (hi, lo) with lo < s, the f rows hi*f*s + lo + j*s (j < f): the
// butterfly stages h = s, 2s, ..., (f/2)s of the whole transform.  The
// sweeps therefore apply the stages in increasing-h order, as the plain
// version does, and each butterfly is an exact IEEE add/sub of the same
// two values, so the result is bit-equal to the plain version.  The scale
// 1/sqrt(m) is passed in and applied once, by the last sweep (the others
// pass 1, which multiplies exactly).  Later factors are addressed with the
// stride s: no transposes are materialised.
//
// One CTA per (group, column slab): the slab (f rows x slab_cols<T>()
// contiguous columns, 128 bytes a row) is loaded into shared memory, all
// log2(f) stages run there, and it is written back.  Each group's rows are
// read and written by its CTA alone, so sweeps after the first run in
// place.
//
// Bound: each sweep reads and writes x once (2 m n sizeof(T) bytes) for
// m n log2(f) adds, so the transform is bound by bytes; the split costs
// one extra read and write of x per extra factor.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kMaxSlabLog2 = 8;                  // MAX_SLAB_LOG2 in kernel.py
constexpr int kMaxSlabRows = 1 << kMaxSlabLog2;  // 256 rows
constexpr int kThreads = 256;

// 128 contiguous bytes of each row per slab: 32 f32, 16 f64 or c64, 8 c128.
template <class T>
__host__ __device__ constexpr int slab_cols() {
  return 128 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float scale_by(float x, float s) { return x * s; }
__device__ __forceinline__ double scale_by(double x, double s) { return x * s; }
template <class R>
__device__ __forceinline__ cplx<R> scale_by(cplx<R> x, R s) {
  return {x.re * s, x.im * s};
}

template <class T>
__global__ void __launch_bounds__(kThreads)
fwht_kernel(const T* x, T* y, int64_t n, int64_t stride, int f_log2,
            real_t<T> scale) {
  constexpr int BN = slab_cols<T>();
  __shared__ T slab[kMaxSlabRows * BN];
  const int f = 1 << f_log2;
  const int64_t g = blockIdx.x;
  const int64_t base = (g / stride) * f * stride + g % stride;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int tid = threadIdx.x;

  for (int e = tid; e < f * BN; e += kThreads) {
    const int j = e / BN, c = e % BN;
    const int64_t col = col0 + c;
    slab[e] = col < n ? x[(base + j * stride) * n + col] : T{};
  }
  for (int h = 1; h < f; h *= 2) {
    __syncthreads();
    for (int p = tid; p < (f / 2) * BN; p += kThreads) {
      const int q = p / BN, c = p % BN;
      const int i = (q / h) * 2 * h + q % h;
      const T u = slab[i * BN + c], v = slab[(i + h) * BN + c];
      slab[i * BN + c] = u + v;
      slab[(i + h) * BN + c] = u - v;
    }
  }
  __syncthreads();
  for (int e = tid; e < f * BN; e += kThreads) {
    const int j = e / BN, c = e % BN;
    const int64_t col = col0 + c;
    if (col < n) y[(base + j * stride) * n + col] = scale_by(slab[e], scale);
  }
}

template <class T>
cudaError_t launch_fwht(const void* x, void* y, int64_t m, int64_t n,
                        int64_t stride, int f_log2, double scale,
                        cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(m >> f_log2),
                  static_cast<unsigned>((n + slab_cols<T>() - 1) /
                                        slab_cols<T>()));
  return launch(fwht_kernel<T>, grid, dim3(kThreads), 0, stream,
                static_cast<const T*>(x), static_cast<T*>(y), n, stride, f_log2,
                static_cast<real_t<T>>(scale));
}

}  // namespace

// One sweep: factor f = 2^f_log2 at row stride `stride` over x (m, n),
// written to y (which may be x).  m must be a power of two, f * stride
// must divide m.
extern "C" int repro_fwht_pass(int dtype, const void* x, void* y, int64_t m,
                               int64_t n, int64_t stride, int f_log2,
                               double scale, void* stream) {
  if (m <= 0 || n <= 0 || (m & (m - 1)) || stride <= 0 || f_log2 < 0 ||
      f_log2 > kMaxSlabLog2 || m % ((int64_t{1} << f_log2) * stride) ||
      (m >> f_log2) > 2147483647LL || (n + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_fwht, x, y, m, n, stride, f_log2, scale, s);
}
