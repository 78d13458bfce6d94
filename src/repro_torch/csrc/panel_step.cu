// Panel kernels of the pivoted QR engines, for Hopper.
//
// Replaces three TPU kernels of repro/kernels/panel_step/kernel.py:
//   panel_step_kernel   -- factor the candidate panel C (l x b) with
//                          CholeskyQR2 and sweep the residual Z (l x n):
//                          W = Q_p^H Z, O = Z - Q_p W, colnorms^2(O);
//   panel_coeff_kernel  -- the factor, W and the downdated norms
//                          max(r2 - colnorms^2(W), 0), no O (stage A of the
//                          distributed panel);
//   panel_apply_kernel  -- O = Z - Q_p W with W given, and colnorms^2(O)
//                          when asked (stage B, and the norm-recompute panel).
// On the TPU, grid step 0 factors the panel and keeps Q_p in VMEM through a
// constant index map for every later slab.
//
// Hopper blocks share nothing, and at the main path Q_p alone (800 x 32
// f64, 205 KB) nearly fills one block's shared memory, so the factor is a
// launch of its own and Q_p goes through global memory:
//   (a) panel_factor_kernel, one CTA: G = C^H C, the clamped Cholesky,
//       X = C L^{-H} by forward substitution over columns; twice (round 2
//       factors the computed Q1, Yamamoto's correction).
//   (b) panel_sweep_kernel<T, kComputeW, kEmitO>, one CTA per 32-column
//       slab of Z.  Pass 1 walks l in 32-row chunks to form W in registers
//       (kComputeW), or W is read from global memory (panel_apply).  Pass 2
//       (kEmitO) walks l again (Z re-read, from L2 where it still holds) for
//       O = Z - Q_p W and the column norms, taken from the unrounded O
//       before the store.  Without pass 2 (panel_coeff) the norms are the
//       downdate max(r2 - colnorms^2(W), 0) from the unrounded W.
//   panel_step = (a) + (b)<T, true, true>; panel_coeff = (a) +
//   (b)<T, true, false>; panel_apply = (b)<T, false, true>.
// Every sum runs in a fixed order (no atomics, no split reductions), so the
// same inputs give the same bits, on every rank of a distributed run.
//
// Dead pivots (as repro_torch/kernels/panel_step/ref.py): a live pivot
// gives L[:, j] = G[:, j] / sqrt(diag), so L[j, j] = diag / sqrt(diag), as
// _chol_masked computes it.  A pivot whose Schur-complement diagonal is at
// most max(tiny, b * eps * G0[j, j]) is rounding noise: its column of L is
// zero and its column of X = C L^{-H} is zero.  A degenerate panel then
// yields a finite Q_p with a zero column, which fails the caller's
// orthogonality check, never a NaN.
//
// Bounds at the main path (f64, l=800, b=32, n=2^14), all by bytes:
// panel_step moves about 210 MB (Z in, O out) for 1.7 GFLOP; panel_coeff
// 110 MB (Z in, W out) for 0.85 GFLOP; panel_apply 214 MB (Z and W in, O
// out) for 0.84 GFLOP.
#include "panel_common.cuh"

namespace {

using namespace repro;

constexpr int kFactorThreads = 512;

// In place: G (b x b, shared) -> lower L with G ~= L L^H, by b right-looking
// rank-1 steps; dead pivots give a zero column.  lj and g0 are b elements of
// shared scratch each.
template <class T>
__device__ void chol_clamped(T* G, T* lj, real_t<T>* g0, int b) {
  using R = real_t<T>;
  const R eps_b = static_cast<R>(b) * eps_of<R>();
  for (int r = threadIdx.x; r < b; r += blockDim.x) {
    const R f = real_of(G[r * b + r]) * eps_b;
    g0[r] = f > tiny_of<R>() ? f : tiny_of<R>();
  }
  __syncthreads();
  for (int j = 0; j < b; ++j) {
    const R diag = real_of(G[j * b + j]);
    const bool live = diag > g0[j];
    const R s = sqrt_r(live ? diag : R(1));
    for (int r = threadIdx.x; r < b; r += blockDim.x) {
      T v{};
      if (live && r == j) v = from_real<T>(diag / s);
      else if (live && r > j) v = div_r(G[r * b + j], s);
      lj[r] = v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
      const int r = e / b, c = e % b;
      if (c > j) G[e] = G[e] - lj[r] * conj_of(lj[c]);
      else if (c == j) G[e] = lj[r];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < b * b; e += blockDim.x)
    if (e % b > e / b) G[e] = T{};
  __syncthreads();
}

// dst = src L^{-H} row by row (rows are independent):
// X[r, j] = (src[r, j] - sum_{i<j} X[r, i] conj(L[j, i])) / L[j, j], and
// X[r, j] = 0 for a dead column (L[j, j] == 0).
// dst may alias src: a row is read in full before it is written.
// The j loop (and the factor's round loop) stay rolled: unrolled, ptxas
// spilled 8 B in the f32, c64 and c128 factors; rolled, only c128 keeps
// an 8 B spill.  The arithmetic, and so the bits, are the same.
template <class T>
__device__ void solve_right_lh(const T* src, T* dst, const T* L, int64_t l, int b) {
  for (int64_t r = threadIdx.x; r < l; r += blockDim.x) {
    T xr[kMaxPanel];
#pragma unroll 1
    for (int j = 0; j < b; ++j) {
      T s{};
      for (int i = 0; i < j; ++i) s = madd(xr[i], conj_of(L[j * b + i]), s);
      const real_t<T> d = real_of(L[j * b + j]);
      xr[j] = d > real_t<T>(0) ? div_r(src[r * b + j] - s, d) : T{};
    }
    for (int j = 0; j < b; ++j) dst[r * b + j] = xr[j];
  }
}

template <class T>
__global__ void __launch_bounds__(kFactorThreads)
panel_factor_kernel(const T* __restrict__ c, T* qp, int64_t l, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* G = reinterpret_cast<T*>(smem_raw);  // b x b
  T* lj = G + b * b;                       // b
  real_t<T>* g0 = reinterpret_cast<real_t<T>*>(lj + b);  // b
#pragma unroll 1
  for (int round = 0; round < 2; ++round) {
    const T* src = round == 0 ? c : qp;
    gram(src, G, l, b);
    __syncthreads();
    chol_clamped(G, lj, g0, b);
    solve_right_lh(src, qp, G, l, b);
    __syncthreads();  // round 2 reads every row of Q1
  }
}

// One CTA per kSweepCols columns of Z (see the file comment for the flags).
// w_out (nullable) receives W when kComputeW; w_in is read when not.
// r2 (nullable when kEmitO) receives colnorms^2(O) when kEmitO, else the
// downdate max(r2_in - colnorms^2(W), 0).
template <class T, bool kComputeW, bool kEmitO>
__global__ void __launch_bounds__(kSweepThreads)
panel_sweep_kernel(const T* __restrict__ qp, const T* __restrict__ z,
                   const T* __restrict__ w_in, const real_t<T>* __restrict__ r2_in,
                   T* __restrict__ o, T* __restrict__ w_out,
                   real_t<T>* __restrict__ r2, int64_t l, int b, int64_t n) {
  static_assert(kComputeW || kEmitO, "a sweep emits W or O");
  using R = real_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kSweepRows x b
  T* zs = qs + kSweepRows * b;             // kSweepRows x kSweepCols
  T* ws = zs + kSweepRows * kSweepCols;    // b x kSweepCols
  R* rs = reinterpret_cast<R*>(ws + b * kSweepCols);  // kSweepWarps x kSweepCols

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kSweepCols;
  const int64_t col = c0 + lane;
  const bool live = col < n;

  R racc = R(0);
  if constexpr (kComputeW) {
    T wacc[kPerWarp];
    coeff_pass(qp, z, l, b, n, c0, qs, zs, wacc);
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      const int p = warp + kSweepWarps * q;
      if (p < b) {
        ws[p * kSweepCols + lane] = wacc[q];
        if (w_out != nullptr && live) w_out[p * n + col] = wacc[q];
        if constexpr (!kEmitO) racc = abs2_add(wacc[q], racc);
      }
    }
  } else {
    for (int e = threadIdx.x; e < b * kSweepCols; e += blockDim.x) {
      const int p = e / kSweepCols, cc = e % kSweepCols;
      ws[e] = (c0 + cc < n) ? w_in[p * n + c0 + cc] : T{};
    }
  }
  __syncthreads();

  if constexpr (kEmitO) {
    // Pass 2: O = Z - Q_p W, one row per warp at a time; norms from O.
    for (int64_t r0 = 0; r0 < l; r0 += kSweepRows) {
      const int rows = static_cast<int>((l - r0 < kSweepRows) ? l - r0 : kSweepRows);
      for (int e = threadIdx.x; e < rows * b; e += blockDim.x)
        qs[e] = qp[r0 * b + e];
      __syncthreads();
      for (int rr = warp; rr < rows; rr += kSweepWarps) {
        T s{};
        for (int p = 0; p < b; ++p) s = madd(qs[rr * b + p], ws[p * kSweepCols + lane], s);
        if (live) {
          const int64_t idx = (r0 + rr) * n + col;
          const T ov = z[idx] - s;
          o[idx] = ov;
          racc = abs2_add(ov, racc);
        }
      }
      __syncthreads();
    }
  }
  if (r2 == nullptr) return;
  rs[warp * kSweepCols + lane] = racc;
  __syncthreads();
  if (warp == 0 && live) {
    R t = rs[lane];
    for (int q = 1; q < kSweepWarps; ++q) t = t + rs[q * kSweepCols + lane];
    if constexpr (!kEmitO) {
      t = r2_in[col] - t;
      t = t < R(0) ? R(0) : t;  // max(., 0) that keeps a NaN
    }
    r2[col] = t;
  }
}

template <class T>
size_t factor_smem(int b) {
  return sizeof(T) * (static_cast<size_t>(b) * b + b) + sizeof(real_t<T>) * b;
}

template <class T>
size_t sweep_smem(int b) {
  return sizeof(T) * (static_cast<size_t>(kSweepRows) * b + kSweepRows * kSweepCols +
                      static_cast<size_t>(b) * kSweepCols) +
         sizeof(real_t<T>) * kSweepWarps * kSweepCols;
}

// The launchers return the launch's status: that of a refused shared-memory
// request, or the launch's own (common.cuh, launch).
template <class T>
cudaError_t launch_factor(const void* c, void* qp, int64_t l, int b, cudaStream_t stream) {
  return launch(panel_factor_kernel<T>, dim3(1), dim3(kFactorThreads), factor_smem<T>(b),
                stream, static_cast<const T*>(c), static_cast<T*>(qp), l, b);
}

template <class T, bool kComputeW, bool kEmitO>
cudaError_t launch_sweep(const void* qp, const void* z, const void* w_in,
                         const void* r2_in, void* o, void* w_out, void* r2, int64_t l,
                         int b, int64_t n, cudaStream_t stream) {
  using R = real_t<T>;
  const unsigned grid = static_cast<unsigned>((n + kSweepCols - 1) / kSweepCols);
  return launch(panel_sweep_kernel<T, kComputeW, kEmitO>, dim3(grid), dim3(kSweepThreads),
                sweep_smem<T>(b), stream, static_cast<const T*>(qp),
                static_cast<const T*>(z), static_cast<const T*>(w_in),
                static_cast<const R*>(r2_in), static_cast<T*>(o), static_cast<T*>(w_out),
                static_cast<R*>(r2), l, b, n);
}

// The three sweeps behind the C entry points.
template <class T>
cudaError_t launch_step_sweep(const void* qp, const void* z, void* o, void* w, void* r2,
                              int64_t l, int b, int64_t n, cudaStream_t s) {
  return launch_sweep<T, true, true>(qp, z, nullptr, nullptr, o, w, r2, l, b, n, s);
}

template <class T>
cudaError_t launch_coeff_sweep(const void* qp, const void* z, const void* r2_in, void* w,
                               void* r2, int64_t l, int b, int64_t n, cudaStream_t s) {
  return launch_sweep<T, true, false>(qp, z, nullptr, r2_in, nullptr, w, r2, l, b, n, s);
}

template <class T>
cudaError_t launch_apply(const void* qp, const void* w, const void* z, void* o, void* r2,
                         int64_t l, int b, int64_t n, cudaStream_t s) {
  return launch_sweep<T, false, true>(qp, z, w, nullptr, o, nullptr, r2, l, b, n, s);
}

bool bad_sizes(int64_t l, int64_t b, int64_t n) {
  return l < 0 || n < 1 || b < 1 || b > kMaxPanel;
}

}  // namespace

extern "C" int repro_panel_factor(int dtype, const void* c, void* qp,
                                  int64_t l, int64_t b, void* stream) {
  if (l < 0 || b < 1 || b > repro::kMaxPanel) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_factor, c, qp, l, static_cast<int>(b), s);
}

extern "C" int repro_panel_sweep(int dtype, const void* qp, const void* z,
                                 void* o, void* w, void* r2, int64_t l,
                                 int64_t b, int64_t n, void* stream) {
  if (bad_sizes(l, b, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_step_sweep, qp, z, o, w, r2, l, static_cast<int>(b), n, s);
}

extern "C" int repro_panel_coeff_sweep(int dtype, const void* qp, const void* z,
                                       const void* r2_in, void* w, void* r2,
                                       int64_t l, int64_t b, int64_t n,
                                       void* stream) {
  if (bad_sizes(l, b, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_coeff_sweep, qp, z, r2_in, w, r2, l, static_cast<int>(b),
                 n, s);
}

extern "C" int repro_panel_apply(int dtype, const void* qp, const void* w,
                                 const void* z, void* o, void* r2, int64_t l,
                                 int64_t b, int64_t n, void* stream) {
  if (bad_sizes(l, b, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_apply, qp, w, z, o, r2, l, static_cast<int>(b), n, s);
}
