// Accumulating sketch GEMM for Hopper: out = acc + x @ a, reduced over a's
// rows in fixed ACCUM_BLOCK-row blocks, in order.
//
// Replaces the TPU kernel sketch_accum_kernel
// (repro/kernels/sketch_accum/kernel.py), whose 1-D grid walks the row
// blocks in order with the (l, n) accumulator resident in VMEM and adds one
// block product per step (o += dot(x_blk, a_blk)).
//
// On Hopper the blocks of a grid run in no order and share nothing, so the
// sequential grid dimension becomes a loop inside each CTA:
//   * the grid covers (l, n) output tiles; a CTA loads its acc tile once
//     into registers (`run`) and walks m block by block;
//   * each 128-row block's product is summed from zero in a second register
//     tile (`blk`) and then added to `run`: the association the JAX kernel
//     pins, so any chunking of m at block multiples replays the same bits;
//   * no split-K and no atomics; ragged edges of l, n and m are masked by
//     loading zeros, which add exactly.
// The accumulator is the element type itself, FFMA/DFMA only: eq. (3)
// needs full precision, so no TF32.
//
// Bound: at the main path (f64, l=800, m=2^16, n=2^14) the work is
// 2 l m n = 1.7e12 flop against ~9.2e9 bytes moved, so the kernel is
// bound by operations.  This is the simple shared-memory tiled form
// (register micro-tiles, one smem stage); wgmma/TMA pipelining is later
// work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kAccumBlock = 128;  // ACCUM_BLOCK, the replay constant
constexpr int kBK = 16;           // rows of a per shared-memory stage
constexpr int kTX = 16, kTY = 16; // threads per CTA: kTX x kTY = 256

// Per-thread micro-tile: two register tiles of TM x TN elements (`run` and
// `blk`) must fit beside the operands, so wider types take smaller tiles.
template <class T> struct AccumTile;
template <> struct AccumTile<float> { static constexpr int TM = 8, TN = 8; };
template <> struct AccumTile<double> { static constexpr int TM = 4, TN = 8; };
template <> struct AccumTile<cplx<float>> { static constexpr int TM = 4, TN = 4; };
template <> struct AccumTile<cplx<double>> { static constexpr int TM = 4, TN = 4; };

template <class T>
__global__ void __launch_bounds__(kTX * kTY)
sketch_accum_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ acc, T* __restrict__ out,
                    int64_t l, int64_t m, int64_t n) {
  constexpr int TM = AccumTile<T>::TM, TN = AccumTile<T>::TN;
  constexpr int BM = kTY * TM, BN = kTX * TN;
  __shared__ T xs[kBK][BM + 1];  // x tile, k-major; +1 breaks bank conflicts
  __shared__ T as[kBK][BN];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  // Thread (ty, tx) owns rows row0 + ty + kTY*i and cols col0 + tx + kTX*j.
  T run[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t r = row0 + ty + kTY * i, c = col0 + tx + kTX * j;
      run[i][j] = (r < l && c < n) ? acc[r * n + c] : T{};
    }
  }

  for (int64_t kb = 0; kb < m; kb += kAccumBlock) {
    const int64_t kend = (kb + kAccumBlock < m) ? kb + kAccumBlock : m;
    T blk[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) blk[i][j] = T{};

    for (int64_t k0 = kb; k0 < kend; k0 += kBK) {
      for (int e = tid; e < BM * kBK; e += kTX * kTY) {
        const int r = e / kBK, kk = e % kBK;
        const int64_t gr = row0 + r, gk = k0 + kk;
        xs[kk][r] = (gr < l && gk < kend) ? x[gr * m + gk] : T{};
      }
      for (int e = tid; e < kBK * BN; e += kTX * kTY) {
        const int kk = e / BN, c = e % BN;
        const int64_t gk = k0 + kk, gc = col0 + c;
        as[kk][c] = (gk < kend && gc < n) ? a[gk * n + gc] : T{};
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        T xr[TM], ar[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) xr[i] = xs[kk][ty + kTY * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) ar[j] = as[kk][tx + kTX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) blk[i][j] = madd(xr[i], ar[j], blk[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) run[i][j] = run[i][j] + blk[i][j];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t r = row0 + ty + kTY * i, c = col0 + tx + kTX * j;
      if (r < l && c < n) out[r * n + c] = run[i][j];
    }
  }
}

template <class T>
void launch_sketch_accum(const void* x, const void* a, const void* acc,
                         void* out, int64_t l, int64_t m, int64_t n,
                         cudaStream_t stream) {
  constexpr int BM = kTY * AccumTile<T>::TM, BN = kTX * AccumTile<T>::TN;
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((l + BM - 1) / BM));
  const dim3 block(kTX, kTY);
  sketch_accum_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(acc), static_cast<T*>(out), l, m, n);
}

}  // namespace

extern "C" int repro_sketch_accum(int dtype, const void* x, const void* a,
                                  const void* acc, void* out, int64_t l,
                                  int64_t m, int64_t n, void* stream) {
  if (l <= 0 || n <= 0 || m < 0 || (l + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_sketch_accum, x, a, acc, out, l, m, n, s);
  return static_cast<int>(cudaGetLastError());
}
