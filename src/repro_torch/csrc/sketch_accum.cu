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
//     (`run`) and walks m block by block;
//   * each 128-row block's product is summed from zero (`blk`) and then
//     added to `run`: the association the JAX kernel pins, so any chunking
//     of m at block multiples replays the same bits;
//   * no split-K and no atomics; ragged edges of l, n and m are masked by
//     loading zeros, which add exactly.
//
// Bound: at the main path (f64, l=800, m=2^16, n=2^14) the work is
// 2 l m n = 1.7e12 flop against ~9.2e9 bytes moved, so the kernel is bound
// by operations: 25.6 ms at the FP64 tensor-core rate (67 TFLOP/s), twice
// that on DFMA.  So f64 runs on the tensor cores (dmma_tile.cuh): DMMA is
// IEEE double precision, eq. (3) holds.  A CTA of 8 warps owns a 128 x 128
// tile; `blk` is the MMA accumulator in registers (64 doubles a thread) and
// `run` sits in shared memory (128 KB), each thread owning its own
// elements, so adding a block needs no barrier; the operands stream
// through a ring of 3 cp.async stages of 16 rows (96 KB).
//
// Raster: row blocks are the fastest grid index (blockIdx.x over
// ceil(l / 128), blockIdx.y over ceil(n / 128)).  A wave of 132 CTAs then
// holds whole columns of output tiles (7 row blocks at l = 800), which read
// the same a[:, slab] at about the same time, so a comes from HBM about
// once (8.6 GB, 2.6 ms) and only x (0.42 GB) is read again each wave.
// With column slabs fastest, each wave swept all of a: about 13 x 8.6 GB,
// 33 ms at 3.35 TB/s, above the bound.
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

constexpr int kAccumBlock = 128;  // ACCUM_BLOCK, the replay constant
constexpr int kAccumStages = 3;   // cp.async ring of the f64 kernel
constexpr int kAccumSmem =
    dmma_smem_bytes(kAccumStages, kDmmaAccs * kDmmaThreads * 8);
static_assert(kAccumBlock % kDmmaBK == 0 && kAccumBlock % kGemmBK == 0,
              "a stage never straddles two blocks");

template <bool kVec16>
__global__ void __launch_bounds__(kDmmaThreads, 1)
sketch_accum_dmma_kernel(const double* __restrict__ x, const double* __restrict__ a,
                         const double* __restrict__ acc, double* __restrict__ out,
                         int64_t l, int64_t m, int64_t n) {
  extern __shared__ __align__(16) double smem[];
  double* run = smem + kAccumStages * 2 * kDmmaTileElems;  // [kDmmaAccs][threads]
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kDmmaBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kDmmaBN;

  DmmaAcc blk;
  dmma_for_each(blk, row0, col0, [&](int i, int64_t r, int64_t c, double& v) {
    run[i * kDmmaThreads + tid] = (r < l && c < n) ? acc[r * n + c] : 0.0;
    v = 0.0;
  });
  constexpr int kStagesPerBlock = kAccumBlock / kDmmaBK;
  dmma_mainloop<false, kVec16, kAccumStages>(
      smem, x, m, l, a, n, n, m, row0, col0, blk, [&](int64_t kt, int64_t ktiles) {
        if ((kt + 1) % kStagesPerBlock != 0 && kt + 1 != ktiles) return;
        dmma_for_each(blk, row0, col0, [&](int i, int64_t, int64_t, double& v) {
          run[i * kDmmaThreads + tid] += v;
          v = 0.0;
        });
      });
  dmma_for_each(blk, row0, col0, [&](int i, int64_t r, int64_t c, double&) {
    if (r < l && c < n) out[r * n + c] = run[i * kDmmaThreads + tid];
  });
}

template <class T>
__global__ void __launch_bounds__(kGemmTX * kGemmTY)
sketch_accum_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ acc, T* __restrict__ out,
                    int64_t l, int64_t m, int64_t n) {
  constexpr int TM = GemmShape<T>::TM, TN = GemmShape<T>::TN;
  __shared__ GemmSmem<T> sm;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * GemmShape<T>::BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * GemmShape<T>::BN;

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

template <bool kVec16>
cudaError_t launch_accum_dmma(const double* x, const double* a, const double* acc,
                              double* out, int64_t l, int64_t m, int64_t n,
                              cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((l + kDmmaBM - 1) / kDmmaBM),
                  static_cast<unsigned>((n + kDmmaBN - 1) / kDmmaBN));
  return launch(sketch_accum_dmma_kernel<kVec16>, grid, dim3(kDmmaThreads), kAccumSmem,
                stream, x, a, acc, out, l, m, n);
}

// Row blocks on blockIdx.x, column slabs on blockIdx.y (at most 65535).
template <class T>
cudaError_t launch_sketch_accum(const void* x_, const void* a_, const void* acc_,
                                void* out_, int64_t l, int64_t m, int64_t n,
                                cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* a = static_cast<const T*>(a_);
  const T* acc = static_cast<const T*>(acc_);
  T* out = static_cast<T*>(out_);
  if constexpr (std::is_same_v<T, double>) {
    if ((n + kDmmaBN - 1) / kDmmaBN > 65535) return cudaErrorInvalidValue;
    return dmma_aligned(x, m) && dmma_aligned(a, n)
               ? launch_accum_dmma<true>(x, a, acc, out, l, m, n, stream)
               : launch_accum_dmma<false>(x, a, acc, out, l, m, n, stream);
  } else {
    constexpr int BM = GemmShape<T>::BM, BN = GemmShape<T>::BN;
    if ((n + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>((l + BM - 1) / BM),
                    static_cast<unsigned>((n + BN - 1) / BN));
    return launch(sketch_accum_kernel<T>, grid, dim3(kGemmTX, kGemmTY), 0, stream, x, a,
                  acc, out, l, m, n);
  }
}

}  // namespace

extern "C" int repro_sketch_accum(int dtype, const void* x, const void* a,
                                  const void* acc, void* out, int64_t l,
                                  int64_t m, int64_t n, void* stream) {
  if (l <= 0 || n <= 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_sketch_accum, x, a, acc, out, l, m, n, s);
}
