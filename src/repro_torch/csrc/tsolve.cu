// Column-parallel blocked triangular solve for Hopper: T with
// triu(R1) @ T = R2 (paper eq. 10), R1 (k, k), R2 and T (k, n).
//
// Replaces the TPU kernel tsolve_kernel (repro/kernels/tsolve/kernel.py),
// whose grid walks 128-column slabs of R2 with R1 and the slab resident in
// VMEM, solving row blocks bottom-up: a (bk x k) @ (k x bn) trailing
// update, then bk sequential rows of the diagonal block.
//
// Bound: k^2 n flop against (k^2 + 2 k n) elements; at the paper's row
// k=400, n=2^14 in f64, 2.6e9 flop and 1.06e8 bytes, bound by operations
// (0.039 ms on the FP64 tensor cores).  Each diagonal block is a chain of
// 32 dependent divisions a column, which no design shortens; the rest is
// kept off that chain: no barrier between its rows, the solved rows in
// shared memory, R1 read once a CTA, the update on the tensor cores.
//
// Every column solves independently (the paper's one processor per column),
// so one CTA of 8 warps owns a slab of NC = kSolveSlabBytes / sizeof(T)
// columns (f64: 64) and walks the row blocks of kSolveRows = 32 rows from
// the bottom:
//   * trailing update b = R2[blk] - R1[blk, below] @ T[below]: R1's band
//     arrives in tiles of 32 rows x kSolveDepth columns through a ring of
//     kSolveStages cp.async stages (one barrier a tile); T[below] is the
//     slab of solved rows kept in shared memory (resident geometry) or, when
//     k x NC does not fit, tiles of T read back beside R1's (re-reading);
//     f64 multiplies on the FP64 tensor cores (mma.sync m16n8k4, IEEE
//     double: each warp a 16-row x 16-column part of the block), f32, c64
//     and c128 on a register tile of TM rows x TN columns a thread (f32 is
//     IEEE FFMA, never TF32);
//     R2's rows of the block are copied beside the update, so b is formed
//     in shared memory;
//   * diagonal block: R1's upper 32 x 32 triangle is staged once a block;
//     each column is solved from the bottom by the Q = 256 / NC threads of
//     one warp, thread q holding the rows = q (mod Q) of b in registers:
//     t_i = (b_i - sum_{j > i} R1[i, j] t_j) / R1[i, i], each R1[i, j] t_j
//     taken off b_i as t_j arrives by a shuffle, the raw diagonal (no
//     reciprocal, no clamp, as the TPU kernel and tsolve_ref), no barrier
//     between rows, and a loop short enough to stay in the instruction
//     cache.
// Only the upper triangle of R1 is read.  k is masked, never padded.  The
// sums run in a fixed order (no atomics, no split of k): repeated calls give
// the same bits; their order differs from tsolve_ref's (the library's), so
// the two agree to a tolerance that grows with the condition of R1.
#include <type_traits>

#include "dmma_tile.cuh"
#include "ring.cuh"

namespace {

using namespace repro;

constexpr int kSolveThreads = 256;     // 8 warps
constexpr int kSolveRows = 32;         // rows a block (BLOCK_ROWS in ref.py)
constexpr int kSolveDepth = 16;        // columns of R1 (rows of T) a ring stage
constexpr int kSolveStages = 4;
constexpr int kSolveSlabBytes = 512;   // bytes of a row of the slab
constexpr int kSolveSmemBudget = 232448;

// Slab columns: f32 128, f64 and c64 64, c128 32.
template <class T>
__host__ __device__ constexpr int solve_cols() {
  return kSolveSlabBytes / static_cast<int>(sizeof(T));
}
static_assert(kSolveThreads / 32 * 16 * 16 == kSolveRows * solve_cols<double>(),
              "the f64 update: 8 warps of 16 rows x 16 columns");
static_assert(kSolveDepth % 16 == 0, "swz permutes columns within groups of 16");

// Register tile of the f32 / c64 / c128 update: TM rows x TN columns a
// thread, 32 x NC over the CTA.
template <class T> struct SolveTile { static constexpr int TM = 4, TN = 4; };
template <> struct SolveTile<cplx<float>> { static constexpr int TM = 4, TN = 2; };
template <> struct SolveTile<cplx<double>> { static constexpr int TM = 4, TN = 1; };

// Dynamic shared bytes: the slab (resident: k rounded up to the stage
// depth; re-reading: one 32-row b block), the diagonal triangle, the ring
// (R1's tile, and T's beside it when re-reading).
template <class T>
size_t solve_smem(bool resident, int64_t k) {
  constexpr int64_t nc = solve_cols<T>(), d = kSolveDepth, br = kSolveRows;
  const int64_t slab = (resident ? (k + d - 1) / d * d : br) * nc;
  const int64_t ring = kSolveStages * (br * d + (resident ? 0 : d * nc));
  return sizeof(T) * static_cast<size_t>(slab + br * (br + 1) + ring);
}

__device__ __forceinline__ float solve_div(float a, float d) { return a / d; }
__device__ __forceinline__ double solve_div(double a, double d) { return a / d; }
template <class R>
__device__ __forceinline__ cplx<R> solve_div(cplx<R> a, cplx<R> d) {
  const R den = abs2_add(d, R(0));
  return div_r(a * conj_of(d), den);
}

// v of lane src of the warp.
__device__ __forceinline__ float shfl_from(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ double shfl_from(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <class R>
__device__ __forceinline__ cplx<R> shfl_from(cplx<R> v, int src) {
  return {shfl_from(v.re, src), shfl_from(v.im, src)};
}

// The update's accumulators: f64 two m16n8 DMMA tiles a warp, the others a
// TM x TN register tile.
template <class T> struct SolveAcc { T v[SolveTile<T>::TM][SolveTile<T>::TN]; };
template <> struct SolveAcc<double> { double v[2][4]; };

// acc += A B over one stage: A the R1 tile (32 x kSolveDepth, pitch
// kSolveDepth), B kSolveDepth rows of T (pitch NC); both swizzled (swz).
template <class T>
__device__ __forceinline__ void solve_stage(const T* a, const T* bt, SolveAcc<T>& acc) {
  constexpr int NC = solve_cols<T>(), D = kSolveDepth;
  if constexpr (std::is_same_v<T, double>) {
    // Warp w: rows 16 (w & 1) + [0, 16), columns 16 (w >> 1) + [0, 16).
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int r = 16 * (warp & 1) + g, c = 16 * (warp >> 1) + g;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 4) {
      const double af[2] = {a[swz(r, k0 + t, D)], a[swz(r + 8, k0 + t, D)]};
#pragma unroll
      for (int q = 0; q < 2; ++q) dmma::mma(acc.v[q], af, bt[swz(k0 + t, c + 8 * q, NC)]);
    }
  } else {
    constexpr int TM = SolveTile<T>::TM, TN = SolveTile<T>::TN, EA = vec_elems<T>();
    constexpr int CG = NC / TN;  // column groups
    const int tm = threadIdx.x / CG, tn = threadIdx.x % CG;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += EA) {
      T av[TM][EA];
#pragma unroll
      for (int i = 0; i < TM; ++i) ld_vec(a + swz(tm * TM + i, k0, D), av[i]);
#pragma unroll
      for (int e = 0; e < EA; ++e) {
        T bv[TN];
#pragma unroll
        for (int j = 0; j < TN; j += vec_elems<T>()) {
          T part[vec_elems<T>()];
          ld_vec(bt + swz(k0 + e, tn * TN + j, NC), part);
#pragma unroll
          for (int u = 0; u < vec_elems<T>(); ++u) bv[j + u] = part[u];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc.v[i][j] = madd(av[i][e], bv[j], acc.v[i][j]);
      }
    }
  }
}

// f(row, col, v) for each accumulator of the thread: (row, col) its place
// in the 32 x NC block.
template <class T, class F>
__device__ __forceinline__ void solve_for_each(SolveAcc<T>& acc, F f) {
  if constexpr (std::is_same_v<T, double>) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(16 * (warp & 1) + g + 8 * (e >> 1), 16 * (warp >> 1) + 8 * q + 2 * t + (e & 1),
          acc.v[q][e]);
  } else {
    constexpr int TM = SolveTile<T>::TM, TN = SolveTile<T>::TN;
    constexpr int CG = solve_cols<T>() / TN;
    const int tm = threadIdx.x / CG, tn = threadIdx.x % CG;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) f(tm * TM + i, tn * TN + j, acc.v[i][j]);
  }
}

template <class T, bool kResident>
__global__ void __launch_bounds__(kSolveThreads, 1)
tsolve_kernel(const T* __restrict__ r1, const T* __restrict__ r2, T* t, int64_t k,
              int64_t n) {
  constexpr int NC = solve_cols<T>(), D = kSolveDepth, S = kSolveStages, BR = kSolveRows;
  // The triangle's pitch: the Q rows a shuffle group reads sit in distinct
  // banks.
  constexpr int DP = BR + 1;
  constexpr int CB = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t kpad = (k + D - 1) / D * D;
  T* slab = reinterpret_cast<T*>(smem_raw);             // resident: kpad x NC; else BR x NC
  T* diag = slab + (kResident ? kpad : BR) * NC;        // BR x DP, upper triangle
  T* ring = diag + BR * DP;                             // S x (BR x D [+ D x NC])
  const int stage = BR * D + (kResident ? 0 : D * NC);
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * NC;
  const int nblk = static_cast<int>((k + BR - 1) / BR);

  if constexpr (kResident) {  // rows past k, read by the last stage's padding
    for (int64_t e = threadIdx.x; e < (kpad - k) * NC; e += kSolveThreads)
      slab[k * NC + e] = T{};
  }

  // Issue cursor: stage (ib, ij) is R1[block ib, ij:ij+D] (and, re-reading,
  // T[ij:ij+D, slab]); the blocks from the bottom, each over j >= its end.
  int ib = nblk - 1;
  int64_t ij = k;
  auto normalize = [&]() {
    while (ib >= 0 && ij >= k) {
      if (--ib >= 0) ij = static_cast<int64_t>(ib + 1) * BR;
    }
  };
  normalize();
  int64_t issued = 0, consumed = 0;
  // The next stage into slot issued % S unless it belongs to a later block
  // than `cur` while re-reading (its rows of T are not solved yet); always
  // a commit, so the wait counts stay uniform.
  auto issue = [&](int cur) {
    if (ib >= 0 && (kResident || ib == cur)) {
      T* st = ring + (issued % S) * stage;
      const int64_t r0 = static_cast<int64_t>(ib) * BR;
      for (int e = threadIdx.x; e < BR * D; e += kSolveThreads) {
        const int rr = e / D, kk = e % D;
        const bool in = ij + kk < k;
        cp_async_bytes<CB>(st + swz(rr, kk, D), in ? r1 + (r0 + rr) * k + ij + kk : r1,
                           in ? CB : 0);
      }
      if constexpr (!kResident) {
        for (int e = threadIdx.x; e < D * NC; e += kSolveThreads) {
          const int kk = e / NC, c = e % NC;
          const bool in = ij + kk < k && col0 + c < n;
          cp_async_bytes<CB>(st + BR * D + swz(kk, c, NC),
                             in ? t + (ij + kk) * n + col0 + c : t, in ? CB : 0);
        }
      }
      ++issued;
      ij += D;
      normalize();
    }
    dmma::cp_async_commit();
  };

  for (int bi = nblk - 1; bi >= 0; --bi) {
    const int64_t r0 = static_cast<int64_t>(bi) * BR;
    const int64_t rend = r0 + BR < k ? r0 + BR : k;
    const int nr = static_cast<int>(rend - r0);
    T* bs = kResident ? slab + r0 * NC : slab;  // this block's R2, b, then T
    // The block's rows of R2 and the diagonal triangle R1[i, j],
    // i <= j < nr, join the next commit.
    for (int e = threadIdx.x; e < nr * NC; e += kSolveThreads) {
      const int rr = e / NC, c = e % NC;
      const bool in = col0 + c < n;
      cp_async_bytes<CB>(bs + swz(rr, c, NC), in ? r2 + (r0 + rr) * n + col0 + c : r2,
                         in ? CB : 0);
    }
    for (int e = threadIdx.x; e < BR * BR; e += kSolveThreads) {
      const int i = e / BR, j = e % BR;
      if (i <= j && j < nr)
        cp_async_bytes<CB>(diag + i * DP + j, r1 + (r0 + i) * k + r0 + j, CB);
    }
    if (!kResident || bi == nblk - 1) {
#pragma unroll
      for (int s = 0; s < S - 1; ++s) issue(bi);
    }

    SolveAcc<T> acc;
    solve_for_each<T>(acc, [](int, int, T& v) { v = T{}; });
    const int64_t stages = (k - rend + D - 1) / D;
    for (int64_t j0 = rend; j0 < k; j0 += D) {
      dmma::cp_async_wait<S - 2>();
      __syncthreads();  // stage landed; every warp is past the one before
      issue(bi);
      const T* st = ring + (consumed % S) * stage;
      ++consumed;
      solve_stage<T>(st, kResident ? slab + j0 * NC : st + BR * D, acc);
    }
    // R2's rows and the triangle went with this block's first commit; the
    // S - 1 newest groups (the next block's stages, when resident) may
    // stay in flight through the diagonal block.
    dmma::cp_async_commit();
    if (stages >= S - 1)
      dmma::cp_async_wait<S - 1>();
    else
      dmma::cp_async_wait<0>();
    __syncthreads();  // R2's rows and the triangle are in shared memory
    solve_for_each<T>(acc, [&](int r, int c, T& v) {  // b = R2[blk] - the update
      if (r < nr) bs[swz(r, c, NC)] = bs[swz(r, c, NC)] - v;
    });
    __syncthreads();

    // Column c from the bottom: Q threads of one warp share it, thread q
    // holding the rows = q (mod Q) in registers.  Row i's owner divides by
    // the raw diagonal, a shuffle hands t_i to the others, and each takes
    // R1[r, i] t_i off its rows r < i: no barrier between rows.
    {
      constexpr int Q = kSolveThreads / NC, CW = 32 / Q, RPT = BR / Q;
      const int lane = threadIdx.x & 31, q = lane / CW;
      const int c = (threadIdx.x >> 5) * CW + lane % CW;
      T bv[RPT];
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        const int r = s * Q + q;
        bv[s] = r < nr ? bs[swz(r, c, NC)] : T{};
      }
      // Unrolled, so that every index into bv is a constant and bv stays
      // in registers (a dynamic index puts it in local memory, which the
      // 227 KB shared-memory carve-out leaves almost no L1 to cache).
#pragma unroll
      for (int i = BR - 1; i >= 0; --i) {
        if (i < nr) {
          const int so = i / Q;  // the owner's slot and lane
          const T ti = shfl_from(solve_div(bv[so], diag[i * DP + i]), (i % Q) * CW + lane % CW);
#pragma unroll
          for (int s = 0; s <= so; ++s) {
            const int r = s * Q + q;
            if (r == i) bv[s] = ti;
            else if (r < i) bv[s] = bv[s] - diag[r * DP + i] * ti;
          }
        }
      }
      const int64_t gc = col0 + c;
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        const int r = s * Q + q;
        if (r < nr) {
          bs[swz(r, c, NC)] = bv[s];
          if (gc < n) t[(r0 + r) * n + gc] = bv[s];
        }
      }
    }
    __syncthreads();  // the block's T is in place; the triangle is free
  }
}

template <class T>
cudaError_t launch_tsolve(const void* r1, const void* r2, void* t, int64_t k, int64_t n,
                          cudaStream_t stream) {
  constexpr int nc = solve_cols<T>();
  const dim3 grid(static_cast<unsigned>((n + nc - 1) / nc)), block(kSolveThreads);
  const T* a = static_cast<const T*>(r1);
  const T* b = static_cast<const T*>(r2);
  T* x = static_cast<T*>(t);
  if (solve_smem<T>(true, k) <= kSolveSmemBudget)
    return launch(tsolve_kernel<T, true>, grid, block, solve_smem<T>(true, k), stream, a, b,
                  x, k, n);
  return launch(tsolve_kernel<T, false>, grid, block, solve_smem<T>(false, k), stream, a, b,
                x, k, n);
}

}  // namespace

extern "C" int repro_tsolve(int dtype, const void* r1, const void* r2,
                            void* t, int64_t k, int64_t n, void* stream) {
  if (k <= 0 || n <= 0 || (n + 31) / 32 > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_tsolve, r1, r2, t, k, n, s);
}
