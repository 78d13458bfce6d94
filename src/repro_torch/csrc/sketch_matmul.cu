// Sketch GEMM for Hopper: Y = omega @ a, one running sum over all of m.
//
// Replaces the TPU kernel sketch_matmul_kernel
// (repro/kernels/sketch_matmul/kernel.py), whose grid (l/bl, n/bn, m/bk)
// walks k innermost, adding each bk-row product into an output tile kept
// in VMEM scratch and writing it back once.
//
// On Hopper the innermost grid dimension becomes a loop inside each CTA:
//   * the grid covers (l, n) output tiles; a CTA walks m in order and
//     stores its tile once;
//   * one running sum per output element, no split-K, no atomics, so the
//     result is deterministic (it differs from sketch_accum, which sums
//     each 128-row block from zero before adding it);
//   * complex types are multiplied in complex arithmetic in this one
//     launch (the TPU wrapper runs four real GEMMs);
//   * ragged l, m and n are masked in the kernel: a is never padded or
//     copied.
//
// Bound: at the paper's row (f64, l=800, m=2^16, n=2^14) the work is
// 2 l m n = 1.7e12 flop against ~9.1e9 bytes, bound by operations: 25.6 ms
// at the FP64 tensor-core rate (67 TFLOP/s), twice that on DFMA.  So f64
// runs on the tensor cores (dmma_tile.cuh; DMMA is IEEE double precision,
// eq. (3) holds): a CTA of 8 warps owns a 128 x 128 tile whose accumulator
// stays in registers as one sum over all of m.  With no running tile in
// shared memory (sketch_accum keeps 128 KB there), the ring takes
// kMatmulStages = 7 cp.async stages of 16 rows (229376 B of the 232448 a
// block may have): six stages in flight while the warps multiply one.
//
// Raster: row blocks are the fastest grid index (blockIdx.x over
// ceil(l / BM), blockIdx.y over ceil(n / BN), at most 65535).  A wave of
// 132 CTAs then holds whole columns of output tiles, which read the same
// a[:, slab] at about the same time, so a comes from HBM about once; with
// column slabs fastest each wave swept all of a (sketch_accum.cu).
//
// f32, c64 and c128 keep the FFMA/DFMA register tile of gemm_tile.cuh on
// the same raster (a CTA's sum order does not depend on it, so their bits
// do not change): f32 must never reach the tensor cores, where it would
// be TF32 and break eq. (3).
#include <type_traits>

#include "dmma_tile.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace repro;

constexpr int kMatmulStages = 7;  // cp.async ring of the f64 kernel
constexpr int kMatmulSmem = dmma_smem_bytes(kMatmulStages);
static_assert(kMatmulSmem <= 232448, "the ring must fit one block");

template <bool kVec16>
__global__ void __launch_bounds__(kDmmaThreads, 1)
sketch_matmul_dmma_kernel(const double* __restrict__ omega, const double* __restrict__ a,
                          double* __restrict__ out, int64_t l, int64_t m, int64_t n) {
  extern __shared__ __align__(16) double smem[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kDmmaBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kDmmaBN;
  DmmaAcc acc;
  dmma_zero(acc);
  dmma_mainloop<false, kVec16, kMatmulStages>(smem, omega, m, l, a, n, n, m, row0, col0,
                                              acc, [](int64_t, int64_t) {});
  dmma_for_each(acc, row0, col0, [&](int, int64_t r, int64_t c, double& v) {
    if (r < l && c < n) out[r * n + c] = v;
  });
}

template <class T>
__global__ void __launch_bounds__(kGemmTX * kGemmTY)
sketch_matmul_kernel(const T* __restrict__ omega, const T* __restrict__ a,
                     T* __restrict__ out, int64_t l, int64_t m, int64_t n) {
  constexpr int TM = GemmShape<T>::TM, TN = GemmShape<T>::TN;
  __shared__ GemmSmem<T> sm;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * GemmShape<T>::BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * GemmShape<T>::BN;

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

template <bool kVec16>
cudaError_t launch_matmul_dmma(const double* omega, const double* a, double* out, int64_t l,
                               int64_t m, int64_t n, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((l + kDmmaBM - 1) / kDmmaBM),
                  static_cast<unsigned>((n + kDmmaBN - 1) / kDmmaBN));
  return launch(sketch_matmul_dmma_kernel<kVec16>, grid, dim3(kDmmaThreads), kMatmulSmem,
                stream, omega, a, out, l, m, n);
}

// Row blocks on blockIdx.x, column slabs on blockIdx.y (at most 65535).
template <class T>
cudaError_t launch_sketch_matmul(const void* omega_, const void* a_, void* out_, int64_t l,
                                 int64_t m, int64_t n, cudaStream_t stream) {
  const T* omega = static_cast<const T*>(omega_);
  const T* a = static_cast<const T*>(a_);
  T* out = static_cast<T*>(out_);
  if constexpr (std::is_same_v<T, double>) {
    if ((n + kDmmaBN - 1) / kDmmaBN > 65535) return cudaErrorInvalidValue;
    return dmma_aligned(omega, m) && dmma_aligned(a, n)
               ? launch_matmul_dmma<true>(omega, a, out, l, m, n, stream)
               : launch_matmul_dmma<false>(omega, a, out, l, m, n, stream);
  } else {
    constexpr int BM = GemmShape<T>::BM, BN = GemmShape<T>::BN;
    if ((n + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>((l + BM - 1) / BM),
                    static_cast<unsigned>((n + BN - 1) / BN));
    return launch(sketch_matmul_kernel<T>, grid, dim3(kGemmTX, kGemmTY), 0, stream, omega, a,
                  out, l, m, n);
  }
}

}  // namespace

extern "C" int repro_sketch_matmul(int dtype, const void* omega,
                                   const void* a, void* out, int64_t l,
                                   int64_t m, int64_t n, void* stream) {
  if (l <= 0 || n <= 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_sketch_matmul, omega, a, out, l, m, n, s);
}
