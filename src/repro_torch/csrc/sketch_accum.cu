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
// (register micro-tiles, one smem stage, gemm_tile.cuh, shared with
// sketch_matmul.cu); wgmma/TMA pipelining is later work.
#include "gemm_tile.cuh"

namespace {

using namespace repro;

constexpr int kAccumBlock = 128;  // ACCUM_BLOCK, the replay constant

template <class T>
__global__ void __launch_bounds__(kGemmTX * kGemmTY)
sketch_accum_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ acc, T* __restrict__ out,
                    int64_t l, int64_t m, int64_t n) {
  constexpr int TM = GemmShape<T>::TM, TN = GemmShape<T>::TN;
  __shared__ GemmSmem<T> sm;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * GemmShape<T>::BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * GemmShape<T>::BN;

  // Thread (ty, tx) owns rows row0 + ty + kGemmTY*i and cols
  // col0 + tx + kGemmTX*j.
  T run[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t r = row0 + ty + kGemmTY * i, c = col0 + tx + kGemmTX * j;
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
    gemm_tile_mac<T>(x, a, l, m, n, row0, col0, kb, kend, blk, sm);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) run[i][j] = run[i][j] + blk[i][j];
  }

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
cudaError_t launch_sketch_accum(const void* x, const void* a, const void* acc,
                                void* out, int64_t l, int64_t m, int64_t n,
                                cudaStream_t stream) {
  return launch(sketch_accum_kernel<T>, gemm_grid<T>(l, n), dim3(kGemmTX, kGemmTY), 0,
                stream, static_cast<const T*>(x), static_cast<const T*>(a),
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
}
