// Register-tiled GEMM step of the f32, c64 and c128 kernels of
// sketch_accum (sketch_accum.cu), sketch_matmul (sketch_matmul.cu) and
// project_out (cgs.cu); their f64 kernels run on the FP64 tensor cores
// (dmma_tile.cuh).  One CTA of kTX x kTY threads owns a BM x BN output
// tile, each thread a TM x TN micro-tile of rows row0 + ty + kTY*i and
// columns col0 + tx + kTX*j.
//
// `gemm_tile_mac` adds x[rows, kb:ke] @ a[kb:ke, cols] into the thread's
// register tile, walking k in order through one shared-memory stage of kBK
// rows at a time; `gemm_stage_mac` is the product over one loaded stage.
// Ragged rows, columns and k are loaded as zeros, which add exactly.  The
// association is fixed by the caller: sketch_accum sums each 128-row block
// from zero and adds it to its running tile; sketch_matmul runs one sum
// over all of m.  The callers lay out their own grids.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kGemmBK = 16;                 // rows of a per shared-memory stage
constexpr int kGemmTX = 16, kGemmTY = 16;   // threads per CTA: 256

// Per-thread micro-tile: sketch_accum keeps two register tiles of TM x TN
// (its running sum and the block sum) beside the operands, so wider types
// take smaller tiles.
template <class T> struct GemmTile;
template <> struct GemmTile<float> { static constexpr int TM = 8, TN = 8; };
template <> struct GemmTile<double> { static constexpr int TM = 4, TN = 8; };
template <> struct GemmTile<cplx<float>> { static constexpr int TM = 4, TN = 4; };
template <> struct GemmTile<cplx<double>> { static constexpr int TM = 4, TN = 4; };

template <class T> struct GemmShape {
  static constexpr int TM = GemmTile<T>::TM, TN = GemmTile<T>::TN;
  static constexpr int BM = kGemmTY * TM, BN = kGemmTX * TN;
};

// Shared-memory stage of one CTA: the x tile k-major (+1 breaks bank
// conflicts) and the a tile.
template <class T> struct GemmSmem {
  T xs[kGemmBK][GemmShape<T>::BM + 1];
  T as[kGemmBK][GemmShape<T>::BN];
};

// acc += xs @ as over one loaded stage, k in order.
template <class T>
__device__ __forceinline__ void gemm_stage_mac(
    T (&acc)[GemmShape<T>::TM][GemmShape<T>::TN], const GemmSmem<T>& sm) {
  constexpr int TM = GemmShape<T>::TM, TN = GemmShape<T>::TN;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int kk = 0; kk < kGemmBK; ++kk) {
    T xr[TM], ar[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) xr[i] = sm.xs[kk][ty + kGemmTY * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) ar[j] = sm.as[kk][tx + kGemmTX * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = madd(xr[i], ar[j], acc[i][j]);
  }
}

template <class T>
__device__ __forceinline__ void gemm_tile_mac(
    const T* __restrict__ x, const T* __restrict__ a, int64_t l, int64_t m,
    int64_t n, int64_t row0, int64_t col0, int64_t kb, int64_t ke,
    T (&acc)[GemmShape<T>::TM][GemmShape<T>::TN], GemmSmem<T>& sm) {
  constexpr int BM = GemmShape<T>::BM, BN = GemmShape<T>::BN;
  constexpr int kThreads = kGemmTX * kGemmTY;
  const int tid = threadIdx.y * kGemmTX + threadIdx.x;
  for (int64_t k0 = kb; k0 < ke; k0 += kGemmBK) {
    for (int e = tid; e < BM * kGemmBK; e += kThreads) {
      const int r = e / kGemmBK, kk = e % kGemmBK;
      const int64_t gr = row0 + r, gk = k0 + kk;
      sm.xs[kk][r] = (gr < l && gk < ke) ? x[gr * m + gk] : T{};
    }
    for (int e = tid; e < kGemmBK * BN; e += kThreads) {
      const int kk = e / BN, c = e % BN;
      const int64_t gk = k0 + kk, gc = col0 + c;
      sm.as[kk][c] = (gk < ke && gc < n) ? a[gk * n + gc] : T{};
    }
    __syncthreads();
    gemm_stage_mac<T>(acc, sm);
    __syncthreads();
  }
}

}  // namespace repro
