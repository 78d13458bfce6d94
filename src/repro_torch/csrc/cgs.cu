// Block projection of classical Gram-Schmidt for Hopper: O = Z - Q (Q^H Z).
//
// Replaces the TPU kernel project_out_kernel (repro/kernels/cgs/kernel.py),
// whose grid walks the column slabs of Z with all of Q (l x k) held in VMEM
// for every slab, and forms W = Q^T Z (k x bn) and O = Z - Q W back to back
// in VMEM.
//
// On Hopper neither Q (up to 2000 x 1000 on the paper's grid, 16 MB in f64)
// nor one slab's W (k x bn: 256 KB at k = 1000, bn = 32 in f64) fits a
// CTA's 227 KB of shared memory, so W goes through device memory:
//   * one CTA owns a BN-column slab of Z (gemm_tile.cuh's tile: 128 columns
//     in f32 and f64, 64 in the complex types);
//   * pass 1 walks k in BM-row chunks of W (64 rows; 128 in f32) and forms
//     each chunk as one register tile summed over l in order,
//     W[chunk, slab] = Q[:, chunk]^H Z[:, slab], stored to a (k, n)
//     workspace that the wrapper allocates;
//   * pass 2 walks l in BM-row chunks and forms
//     O[chunk, slab] = Z[chunk, slab] - Q[chunk, :] W[:, slab], summed over
//     k in order, reading the slab's W back (from L2: the CTA has just
//     written it).
// A slab's W is written and read by its own CTA only, so a barrier orders
// the two passes; it is read through a plain pointer, never the read-only
// (non-coherent) path.  One launch, no atomics, every sum in a fixed order:
// the same inputs give the same bits.  Complex types run in complex
// arithmetic in the same launch (Q conjugated as pass 1 loads it); ragged
// l, k and n are masked in the loads, so Z is never padded.  The
// accumulator is the element type: FFMA / DFMA, never TF32.
//
// Bound: at l=800, k=400, n=2^14 in f64 the work is 4 l k n = 2.1e10 flop
// against ~2.1e8 bytes (Z in, O out, Q), bound by operations (0.31 ms at
// the FP64 tensor-core rate).  This is the simple register-tiled form; DMMA
// tiles, a cp.async or TMA pipeline, and W kept on chip where k allows are
// later work.
//
// panel_deflate_kernel, the same product for one panel (b <= 64) with W as
// a second output, is the panel sweep of panel_step.cu
// (repro_panel_deflate there).
#include "gemm_tile.cuh"

namespace {

using namespace repro;

// acc += X[rows, 0:depth] @ a[0:depth, cols] for the CTA's tile at (row0,
// col0), as gemm_tile_mac, with X = x (rows x depth, leading dimension
// ldx) or, with kConjT, X = x^H for x (depth x rows, leading dimension
// ldx).  No __restrict__: pass 2 reads the workspace pass 1 wrote.
template <class T, bool kConjT>
__device__ __forceinline__ void tile_mac(
    const T* x, const T* a, int64_t ldx, int64_t rows, int64_t n,
    int64_t row0, int64_t col0, int64_t depth,
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

template <class T>
__device__ __forceinline__ void zero_tile(T (&acc)[GemmShape<T>::TM][GemmShape<T>::TN]) {
#pragma unroll
  for (int i = 0; i < GemmShape<T>::TM; ++i)
#pragma unroll
    for (int j = 0; j < GemmShape<T>::TN; ++j) acc[i][j] = T{};
}

// One CTA per BN-column slab of Z; w is the (k, n) workspace.
template <class T>
__global__ void __launch_bounds__(kGemmTX * kGemmTY)
project_out_kernel(const T* __restrict__ q, const T* __restrict__ z, T* w,
                   T* __restrict__ o, int64_t l, int64_t k, int64_t n) {
  constexpr int TM = GemmShape<T>::TM, TN = GemmShape<T>::TN;
  constexpr int BM = GemmShape<T>::BM, BN = GemmShape<T>::BN;
  __shared__ GemmSmem<T> sm;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  T acc[TM][TN];

  // Pass 1: W[:, slab] = Q^H Z[:, slab], BM rows of W at a time.
  for (int64_t row0 = 0; row0 < k; row0 += BM) {
    zero_tile<T>(acc);
    tile_mac<T, true>(q, z, k, k, n, row0, col0, l, acc, sm);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int64_t r = row0 + ty + kGemmTY * i, c = col0 + tx + kGemmTX * j;
        if (r < k && c < n) w[r * n + c] = acc[i][j];
      }
  }
  __syncthreads();  // the slab's W, written above, is read below

  // Pass 2: O[:, slab] = Z[:, slab] - Q W[:, slab], BM rows of O at a time.
  for (int64_t row0 = 0; row0 < l; row0 += BM) {
    zero_tile<T>(acc);
    tile_mac<T, false>(q, w, k, l, n, row0, col0, k, acc, sm);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int64_t r = row0 + ty + kGemmTY * i, c = col0 + tx + kGemmTX * j;
        if (r < l && c < n) o[r * n + c] = z[r * n + c] - acc[i][j];
      }
  }
}

template <class T>
cudaError_t launch_project_out(const void* q, const void* z, void* w, void* o,
                               int64_t l, int64_t k, int64_t n, cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((n + GemmShape<T>::BN - 1) / GemmShape<T>::BN);
  return launch(project_out_kernel<T>, dim3(grid), dim3(kGemmTX, kGemmTY), 0, stream,
                static_cast<const T*>(q), static_cast<const T*>(z), static_cast<T*>(w),
                static_cast<T*>(o), l, k, n);
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
