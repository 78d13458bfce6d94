// Block projection of classical Gram-Schmidt for Hopper: O = Z - Q (Q^H Z).
//
// Replaces the TPU kernel project_out_kernel (repro/kernels/cgs/kernel.py),
// whose grid walks the column slabs of Z with all of Q (l x k) held in VMEM
// for every slab, and forms W = Q^T Z (k x bn) and O = Z - Q W back to back
// in VMEM.
//
// On Hopper neither Q (up to 2000 x 1000 on the paper's grid, 16 MB in f64)
// nor one slab's W (k x 128: 1 MB at k = 1000 in f64) fits a CTA's 227 KB
// of shared memory, so W goes through a (k, n) workspace in device memory
// that the wrapper allocates, and the product is two GEMMs, two launches
// on one stream from the one C entry point:
//   1. W = Q^H Z: a (ceil(k / BM), ceil(n / BN)) grid of output tiles of W,
//      each summed over l in order;
//   2. O = Z - Q W: a (ceil(l / BM), ceil(n / BN)) grid of output tiles of
//      O, each summed over k in order, the subtraction in the epilogue.
// Row blocks are the fastest grid index, so a wave's CTAs share their
// column slab of Z (pass 1) or W (pass 2).  Every sum has a fixed order
// and no atomics: the same inputs give the same bits.  Ragged l, k and n
// are masked in the loads, so Z is never padded.
//
// Bound: at l=800, k=400, n=2^14 in f64 the work is 4 l k n = 2.1e10 flop
// against ~2.1e8 bytes (Z in, O out, Q; the workspace adds 2 k n x 8 B,
// 0.03 ms of HBM), bound by operations: 0.31 ms at the FP64 tensor-core
// rate.  So f64 runs both passes on DMMA tiles of 128 x 128
// (dmma_tile.cuh; pass 1 reads its Q stage transposed, and for a real type
// the conjugate is the identity), with a ring of 4 cp.async stages.  f32,
// c64 and c128 run the FFMA/DFMA register tile of gemm_tile.cuh in the same
// two launches (Q conjugated as pass 1 loads it): f32 never reaches the
// tensor cores (TF32 would break eq. (3)).
//
// panel_deflate_kernel, the same product for one panel (b <= 64) with W as
// a second output, is the panel sweep of panel_step.cu
// (repro_panel_deflate there).
#include <type_traits>

#include "dmma_tile.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace repro;

constexpr int kProjectStages = 4;  // cp.async ring of the f64 kernels
constexpr int kProjectSmem = dmma_smem_bytes(kProjectStages);

// W = Q^H Z for q (l x k) and z (l x n): the (k, n) tile at blockIdx.
template <bool kVec16>
__global__ void __launch_bounds__(kDmmaThreads, 1)
project_w_dmma_kernel(const double* __restrict__ q, const double* __restrict__ z,
                      double* __restrict__ w, int64_t l, int64_t k, int64_t n) {
  extern __shared__ __align__(16) double smem[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kDmmaBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kDmmaBN;
  DmmaAcc acc;
  dmma_zero(acc);
  dmma_mainloop<true, kVec16, kProjectStages>(smem, q, k, k, z, n, n, l, row0, col0,
                                              acc, [](int64_t, int64_t) {});
  dmma_for_each(acc, row0, col0, [&](int, int64_t r, int64_t c, double& v) {
    if (r < k && c < n) w[r * n + c] = v;
  });
}

// O = Z - Q W for w (k x n): the (l, n) tile at blockIdx.
template <bool kVec16>
__global__ void __launch_bounds__(kDmmaThreads, 1)
project_o_dmma_kernel(const double* __restrict__ q, const double* __restrict__ z,
                      const double* __restrict__ w, double* __restrict__ o,
                      int64_t l, int64_t k, int64_t n) {
  extern __shared__ __align__(16) double smem[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kDmmaBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kDmmaBN;
  DmmaAcc acc;
  dmma_zero(acc);
  dmma_mainloop<false, kVec16, kProjectStages>(smem, q, k, l, w, n, n, k, row0, col0,
                                               acc, [](int64_t, int64_t) {});
  dmma_for_each(acc, row0, col0, [&](int, int64_t r, int64_t c, double& v) {
    if (r < l && c < n) o[r * n + c] = z[r * n + c] - v;
  });
}

// acc += X[rows, 0:depth] @ a[0:depth, cols] for the CTA's tile at (row0,
// col0), as gemm_tile_mac, with X = x (rows x depth, leading dimension
// ldx) or, with kConjT, X = x^H for x (depth x rows, leading dimension
// ldx).
template <class T, bool kConjT>
__device__ __forceinline__ void tile_mac(
    const T* __restrict__ x, const T* __restrict__ a, int64_t ldx, int64_t rows,
    int64_t n, int64_t row0, int64_t col0, int64_t depth,
    T (&acc)[GemmShape<T>::TM][GemmShape<T>::TN], GemmSmem<T>& sm) {
  constexpr int BM = GemmShape<T>::BM, BN = GemmShape<T>::BN;
  constexpr int kThreads = kGemmTX * kGemmTY;
  const int tid = threadIdx.y * kGemmTX + threadIdx.x;
  for (int64_t k0 = 0; k0 < depth; k0 += kGemmBK) {
    for (int e = tid; e < BM * kGemmBK; e += kThreads) {
      // Neighbouring threads on neighbouring addresses of x.
      const int r = kConjT ? e % BM : e / kGemmBK;
      const int kk = kConjT ? e / BM : e % kGemmBK;
      const int64_t gr = row0 + r, gk = k0 + kk;
      T v{};
      if (gr < rows && gk < depth)
        v = kConjT ? conj_of(x[gk * ldx + gr]) : x[gr * ldx + gk];
      sm.xs[kk][r] = v;
    }
    for (int e = tid; e < kGemmBK * BN; e += kThreads) {
      const int kk = e / BN, c = e % BN;
      const int64_t gk = k0 + kk, gc = col0 + c;
      sm.as[kk][c] = (gk < depth && gc < n) ? a[gk * n + gc] : T{};
    }
    __syncthreads();
    gemm_stage_mac<T>(acc, sm);
    __syncthreads();
  }
}

// One output tile of W = Q^H Z (kSecond false: rows of W, depth l) or of
// O = Z - Q W (kSecond: rows of O, depth k) at blockIdx.
template <class T, bool kSecond>
__device__ __forceinline__ void project_tile(const T* __restrict__ q,
                                             const T* __restrict__ z,
                                             const T* __restrict__ w,
                                             T* __restrict__ out, int64_t l,
                                             int64_t k, int64_t n, GemmSmem<T>& sm) {
  constexpr int TM = GemmShape<T>::TM, TN = GemmShape<T>::TN;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * GemmShape<T>::BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * GemmShape<T>::BN;
  const int64_t rows = kSecond ? l : k;
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T{};
  if constexpr (kSecond)
    tile_mac<T, false>(q, w, k, l, n, row0, col0, k, acc, sm);
  else
    tile_mac<T, true>(q, z, k, k, n, row0, col0, l, acc, sm);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t r = row0 + ty + kGemmTY * i, c = col0 + tx + kGemmTX * j;
      if (r < rows && c < n) out[r * n + c] = kSecond ? z[r * n + c] - acc[i][j] : acc[i][j];
    }
}

// One block an SM may use all 255 registers a thread: without the bound
// ptxas keeps the c128 W kernel at 128 registers and spills.
template <class T>
__global__ void __launch_bounds__(kGemmTX * kGemmTY, 1)
project_w_kernel(const T* __restrict__ q, const T* __restrict__ z, T* __restrict__ w,
                 int64_t l, int64_t k, int64_t n) {
  __shared__ GemmSmem<T> sm;
  project_tile<T, false>(q, z, nullptr, w, l, k, n, sm);
}

template <class T>
__global__ void __launch_bounds__(kGemmTX * kGemmTY, 1)
project_o_kernel(const T* __restrict__ q, const T* __restrict__ z,
                 const T* __restrict__ w, T* __restrict__ o, int64_t l, int64_t k,
                 int64_t n) {
  __shared__ GemmSmem<T> sm;
  project_tile<T, true>(q, z, w, o, l, k, n, sm);
}

// Pass 1 (when k > 0), then pass 2 (when l > 0), on `stream`, as DMMA
// tiles; the first refused launch's status.
template <bool kVec16>
cudaError_t launch_project_dmma(const double* q, const double* z, double* w, double* o,
                                int64_t l, int64_t k, int64_t n, dim3 grid_w,
                                dim3 grid_o, cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
  if (k > 0)
    e = launch(project_w_dmma_kernel<kVec16>, grid_w, dim3(kDmmaThreads), kProjectSmem,
               stream, q, z, w, l, k, n);
  if (e == cudaSuccess && l > 0)
    e = launch(project_o_dmma_kernel<kVec16>, grid_o, dim3(kDmmaThreads), kProjectSmem,
               stream, q, z, static_cast<const double*>(w), o, l, k, n);
  return e;
}

// The same two passes for every type: DMMA tiles for f64, the register
// tile of gemm_tile.cuh for the others.
template <class T>
cudaError_t launch_project_out(const void* q_, const void* z_, void* w_, void* o_,
                               int64_t l, int64_t k, int64_t n, cudaStream_t stream) {
  const T* q = static_cast<const T*>(q_);
  const T* z = static_cast<const T*>(z_);
  T* w = static_cast<T*>(w_);
  T* o = static_cast<T*>(o_);
  constexpr bool kDmma = std::is_same_v<T, double>;
  constexpr int BM = kDmma ? kDmmaBM : GemmShape<T>::BM;
  constexpr int BN = kDmma ? kDmmaBN : GemmShape<T>::BN;
  if ((n + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  const unsigned gy = static_cast<unsigned>((n + BN - 1) / BN);
  const dim3 grid_w(static_cast<unsigned>((k + BM - 1) / BM), gy);
  const dim3 grid_o(static_cast<unsigned>((l + BM - 1) / BM), gy);
  if constexpr (kDmma) {
    const bool v16 = dmma_aligned(q, k) && dmma_aligned(z, n) && dmma_aligned(w, n);
    return v16 ? launch_project_dmma<true>(q, z, w, o, l, k, n, grid_w, grid_o, stream)
               : launch_project_dmma<false>(q, z, w, o, l, k, n, grid_w, grid_o, stream);
  } else {
    const dim3 block(kGemmTX, kGemmTY);
    cudaError_t e = cudaSuccess;
    if (k > 0) e = launch(project_w_kernel<T>, grid_w, block, 0, stream, q, z, w, l, k, n);
    if (e == cudaSuccess && l > 0)
      e = launch(project_o_kernel<T>, grid_o, block, 0, stream, q, z,
                 static_cast<const T*>(w), o, l, k, n);
    return e;
  }
}

}  // namespace

// q (l, k), z (l, n), w (k, n) workspace, o (l, n); all row-major.
extern "C" int repro_project_out(int dtype, const void* q, const void* z,
                                 void* w, void* o, int64_t l, int64_t k,
                                 int64_t n, void* stream) {
  if (l < 0 || k < 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_project_out, q, z, w, o, l, k, n, s);
}
