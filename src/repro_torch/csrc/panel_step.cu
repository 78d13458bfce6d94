// Panel kernels of the pivoted QR engines, for Hopper.
//
// Replaces two TPU kernels of repro/kernels/panel_step/kernel.py:
//   panel_step_kernel   -- factor the candidate panel C (l x b) with
//                          CholeskyQR2 and sweep the residual Z (l x n):
//                          W = Q_p^H Z, O = Z - Q_p W, colnorms^2(O);
//   panel_coeff_kernel  -- the factor, W and the downdated norms
//                          max(r2 - colnorms^2(W), 0), no O (stage A of the
//                          distributed panel).
// The third, panel_apply_kernel (stage B), has a kernel of its own in
// panel_apply.cu.
// On the TPU, grid step 0 factors the panel and keeps Q_p in VMEM through a
// constant index map for every later slab.
//
// Hopper blocks share nothing, and at the main path Q_p alone (800 x 32
// f64, 205 KB) nearly fills one block's shared memory, so the factor is a
// launch of its own and Q_p goes through global memory:
//   (a) panel_factor_kernel<T, kResident>, one CTA of 512 threads: G =
//       X^H X, the clamped Cholesky, X L^{-H} by forward substitution over
//       columns; twice (round 2 factors the computed Q1, Yamamoto's
//       correction).  When the panel fits (f64 and c64 up to b = 32 at
//       l = 800, f32 up to b = 64, c128 up to 16), it is copied into
//       shared memory once and both rounds run there, in place; the
//       re-reading twin <T, false> reads C and Q1 from global memory.  The
//       panel and G have an odd row pitch (b | 1), so that a warp reading
//       one element of 32 rows hits distinct banks.  The Gram forms only
//       the lower triangle, the part the Cholesky reads, a 2 x 2 block a
//       thread; the Cholesky (b <= 32) runs in warp 0 alone, a row a lane,
//       with __syncwarp() for the block barriers of its b steps; the solve
//       runs a row a thread with both loops unrolled, its solved entries
//       read back from the panel (no per-thread array, no stack frame).
//   (b) panel_step's sweep: W = Q_p^H Z by panel_gram's pass over Z
//       (panel_gram.cu, with no Gram tile), then O = Z - Q_p W and
//       colnorms^2(O) by panel_apply.cu's kernel with its norms: two
//       launches of one C entry, each reading Z once, wide slabs fed by
//       cp.async rings.  A kernel that kept each 32-column slab of Z
//       resident (Z read once) measured 0.30 ms at the main shape, about
//       twice the pair: beside a 205 KB slab only 16 KB of shared memory
//       is left for Q_p, which each CTA streams from L2 in both passes, so
//       every 32-row chunk waited out an L2 round trip (PERF.md).
//   (c) panel_coeff's sweep: the same W pass of panel_gram.cu with the
//       norms' downdate max(r2 - colnorms^2(W), 0), from the unrounded W,
//       in its epilogue (each CTA reads its W slab back from L2): one
//       launch, Z read once.  It replaced a kernel of one CTA per
//       32-column slab that staged l in 32-row chunks with synchronous
//       copies and two barriers a chunk (0.19 against 0.08 ms at the main
//       shape; PERF.md).  A third launch reading W back for the downdate
//       measured 0.002-0.003 ms slower than the epilogue.
//   panel_step = (a) + (b); panel_coeff = (a) + (c).
// Every sum runs in a fixed order (no atomics, no split reductions), so the
// same inputs give the same bits, on every rank of a distributed run, and
// the kernels share their arithmetic:
//   * G[i, j] = sum_r madd(conj(X[r, i]), X[r, j], s), r in order from 0;
//   * the Cholesky below, one step at a time;
//   * X[r, j] = (src[r, j] - sum_{i<j} madd(X[r, i], conj(L[j, i]), s))
//     / L[j, j], i in order from 0;
//   * W[p, c] = sum_r madd(conj(Q[r, p]), Z[r, c], s), r in order from 0;
//   * O[r, c] = Z[r, c] - sum_p madd(Q[r, p], W[p, c], s), p = 0..b-1 in
//     order from 0, the last b % E columns unpadded (a 0 x 0 term can turn
//     an underflowed -0 into +0);
//   * the norm of a column: 8 partials, partial g summing |O|^2 (|W|^2 in
//     panel_coeff's downdate) of the rows = g (mod 8) in increasing order,
//     added in g order.
// panel_gram and panel_apply keep these sums (their files), so panel_step
// and panel_coeff keep the bits of the kernels they replaced.
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
// 110 MB (Z in, W out) for 0.85 GFLOP.  The factor's 2 x (2 l b^2 + l b^2)
// flop run on one SM: 4.9e7 FMA-steps, about 7 us of its DFMA rate a Gram.
#include "dmma_tile.cuh"
#include "panel_common.cuh"
#include "ring.cuh"

namespace {

using namespace repro;

constexpr int kFactorThreads = 512;
constexpr int kFactorSmemBudget = 232448;

// In place: G (b x b, shared, row pitch gp) -> lower L with G ~= L L^H,
// by b right-looking rank-1 steps; dead pivots give a zero column.  lj and
// g0 are b elements of shared scratch each.
template <class T>
__device__ void chol_clamped(T* G, int gp, T* lj, real_t<T>* g0, int b) {
  using R = real_t<T>;
  const R eps_b = static_cast<R>(b) * eps_of<R>();
  for (int r = threadIdx.x; r < b; r += blockDim.x) {
    const R f = real_of(G[r * gp + r]) * eps_b;
    g0[r] = f > tiny_of<R>() ? f : tiny_of<R>();
  }
  __syncthreads();
  for (int j = 0; j < b; ++j) {
    const R diag = real_of(G[j * gp + j]);
    const bool live = diag > g0[j];
    const R s = sqrt_r(live ? diag : R(1));
    for (int r = threadIdx.x; r < b; r += blockDim.x) {
      T v{};
      if (live && r == j) v = from_real<T>(diag / s);
      else if (live && r > j) v = div_r(G[r * gp + j], s);
      lj[r] = v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
      const int r = e / b, c = e % b;
      if (c > j) G[r * gp + c] = G[r * gp + c] - lj[r] * conj_of(lj[c]);
      else if (c == j) G[r * gp + c] = lj[r];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < b * b; e += blockDim.x)
    if (e % b > e / b) G[(e / b) * gp + e % b] = T{};
  __syncthreads();
}

// chol_clamped by warp 0 alone, for b <= 32: lane r owns row r of G, and
// each step's column goes through lj between __syncwarp()s, so the b steps
// need no block barrier.  Every entry goes through chol_clamped's
// operations (and so gets its bits).  The caller syncs the block after.
template <class T>
__device__ void chol_lanes(T* G, int gp, T* lj, int b) {
  using R = real_t<T>;
  if (threadIdx.x >= 32) return;
  const int r = threadIdx.x;
  R g0 = tiny_of<R>();
  if (r < b) {
    const R f = real_of(G[r * gp + r]) * (static_cast<R>(b) * eps_of<R>());
    g0 = f > tiny_of<R>() ? f : tiny_of<R>();
  }
  T* row = G + r * gp;
  for (int j = 0; j < b; ++j) {
    const R diag = real_of(G[j * gp + j]);
    const bool live = diag > __shfl_sync(0xffffffffu, g0, j);
    const R s = sqrt_r(live ? diag : R(1));
    T v{};
    if (live && r == j) v = from_real<T>(diag / s);
    else if (live && r > j && r < b) v = div_r(row[j], s);
    if (r < b) lj[r] = v;
    __syncwarp();
    if (r < b) {
      // K entries at a time, their loads ahead of their stores.
      constexpr int K = sizeof(T) == 16 ? 4 : 8;
      for (int c0 = j + 1; c0 < b; c0 += K) {
        T a[K], w[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (c0 + k < b) {
            a[k] = row[c0 + k];
            w[k] = lj[c0 + k];
          }
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (c0 + k < b) row[c0 + k] = a[k] - v * conj_of(w[k]);
      }
      row[j] = v;
    }
    __syncwarp();
  }
  if (r < b)
    for (int c = r + 1; c < b; ++c) row[c] = T{};
}

// Row pitches: G's odd, so that the Cholesky's lanes, a row each, hit
// distinct banks; the resident panel's even, so that columns 2 i, 2 i + 1
// of a row are one aligned pair for the Gram (the solve's lanes, a row
// each, then meet 2-way conflicts at most), and odd in c128, whose pair is
// two 16-byte loads anyway.
__host__ __device__ constexpr int factor_pitch(int b) { return b | 1; }
template <class T>
__host__ __device__ constexpr int panel_pitch(int b) {
  return sizeof(T) == 16 ? (b | 1) : (b + 1) / 2 * 2 + 2;
}

// Two consecutive elements at p (aligned to two elements).
__device__ __forceinline__ void ld_pair(const float* p, float& a, float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void ld_pair(const double* p, double& a, double& b) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void ld_pair(const cplx<float>* p, cplx<float>& a, cplx<float>& b) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  a = {x.x, x.y};
  b = {x.z, x.w};
}
__device__ __forceinline__ void ld_pair(const cplx<double>* p, cplx<double>& a,
                                        cplx<double>& b) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 1);
  a = {x.x, x.y};
  b = {y.x, y.y};
}

// G = X^H X for X (l x b, row pitch ld, shared or global memory), G
// (b x b, row pitch gp) in shared memory: its lower triangle, the only
// part the Cholesky reads (the strict upper triangle is written as zeros).
// A thread owns the 2 x 2 block at rows 2 ti, columns 2 tj, tj <= ti; each
// element one sum over l in order.  kPairs (the resident panel, even
// pitch): each pair of columns one load (past b, a pad column read and
// not used).
template <class T, bool kPairs>
__device__ void gram_lower(const T* X, int64_t ld, T* G, int gp, int64_t l, int b) {
  for (int e = threadIdx.x; e < b * b; e += blockDim.x)
    if (e % b > e / b) G[(e / b) * gp + e % b] = T{};
  const int ih = (b + 1) / 2;
  for (int tile = threadIdx.x; tile < ih * (ih + 1) / 2; tile += blockDim.x) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    const int i0 = 2 * ti, j0 = 2 * (tile - ti * (ti + 1) / 2);
    T acc[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int k = 0; k < 2; ++k) acc[a][k] = T{};
#pragma unroll 4
    for (int64_t r = 0; r < l; ++r) {
      const T* row = X + r * ld;
      T xi[2], xj[2];
      if constexpr (kPairs) {
        ld_pair(row + i0, xi[0], xi[1]);
        ld_pair(row + j0, xj[0], xj[1]);
      } else {
        xi[0] = row[i0];
        xi[1] = i0 + 1 < b ? row[i0 + 1] : T{};
        xj[0] = row[j0];
        xj[1] = j0 + 1 < b ? row[j0 + 1] : T{};
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int k = 0; k < 2; ++k) acc[a][k] = madd(conj_of(xi[a]), xj[k], acc[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (i0 + a < b && j0 + k <= i0 + a) G[(i0 + a) * gp + j0 + k] = acc[a][k];
  }
}

// A load of shared memory that the compiler keeps where it is written (a
// loop-invariant one is not hoisted out of the row loop into registers).
__device__ __forceinline__ float ld_here(const float* p) {
  return *reinterpret_cast<const volatile float*>(p);
}
__device__ __forceinline__ double ld_here(const double* p) {
  return *reinterpret_cast<const volatile double*>(p);
}
template <class R>
__device__ __forceinline__ cplx<R> ld_here(const cplx<R>* p) {
  return {ld_here(&p->re), ld_here(&p->im)};
}

// X L^{-H} in place on the resident panel (l x b, row pitch ld), a row a
// thread (rows are independent; b <= KB):
// X[r, j] = (X[r, j] - sum_{i<j} X[r, i] conj(L[j, i])) / L[j, j], and
// X[r, j] = 0 for a dead column (L[j, j] == 0).  Both loops are unrolled
// (KB > 0), so the loads of a step do not wait on its sum; the solved
// entries are read back from the panel (no per-thread array, no stack
// frame).  KB = 0 keeps both loops rolled (c128, and 8-byte types past 32
// columns, whose unrolled loads would spill).
template <class T, int KB>
__device__ void solve_rows(T* X, int64_t ld, const T* L, int gp, int64_t l, int b) {
  for (int64_t r = threadIdx.x; r < l; r += blockDim.x) {
    T* row = X + r * ld;
#pragma unroll
    for (int j = 0; j < (KB > 0 ? KB : b); ++j) {
      if (j >= b) break;
      T s{};
#pragma unroll
      for (int i = 0; i < j; ++i) s = madd(row[i], conj_of(ld_here(L + j * gp + i)), s);
      const real_t<T> d = real_of(ld_here(L + j * gp + j));
      row[j] = d > real_t<T>(0) ? div_r(row[j] - s, d) : T{};
    }
  }
}

// The re-reading factor's solve: dst = src L^{-H} (row pitch b), a row's
// solved entries in a per-thread array (local memory, cached in L1),
// written to dst once the row is done; dst may alias src.
template <class T>
__device__ void solve_right_lh(const T* src, T* dst, const T* L, int gp, int64_t l, int b) {
  for (int64_t r = threadIdx.x; r < l; r += blockDim.x) {
    T xr[kMaxPanel];
#pragma unroll 1
    for (int j = 0; j < b; ++j) {
      T s{};
      for (int i = 0; i < j; ++i) s = madd(xr[i], conj_of(L[j * gp + i]), s);
      const real_t<T> d = real_of(L[j * gp + j]);
      xr[j] = d > real_t<T>(0) ? div_r(src[r * b + j] - s, d) : T{};
    }
    for (int j = 0; j < b; ++j) dst[r * b + j] = xr[j];
  }
}

template <class T, bool kResident>
__global__ void __launch_bounds__(kFactorThreads, 1)
panel_factor_kernel(const T* __restrict__ c, T* qp, int64_t l, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gp = factor_pitch(b), xp = panel_pitch<T>(b);
  T* X = reinterpret_cast<T*>(smem_raw);                  // l x xp (resident)
  T* G = X + (kResident ? l * xp : 0);                    // b x gp
  T* lj = G + b * gp;                                     // b
  real_t<T>* g0 = reinterpret_cast<real_t<T>*>(lj + b);   // b
  // The copies in and out: thread t moves column t % b of rows t / b,
  // t / b + rows_a_pass, ... (no division a element).
  const int rows_a_pass = kFactorThreads / b, p = threadIdx.x % b;
  const bool mover = threadIdx.x < rows_a_pass * b;
  if constexpr (kResident) {
    if (mover)
      for (int64_t r = threadIdx.x / b; r < l; r += rows_a_pass)
        cp_async_bytes<static_cast<int>(sizeof(T))>(X + r * xp + p, c + r * b + p,
                                                    static_cast<int>(sizeof(T)));
    dmma::cp_async_commit();
    dmma::cp_async_wait<0>();
    __syncthreads();
  }
#pragma unroll 1
  for (int round = 0; round < 2; ++round) {
    if constexpr (kResident) {
      gram_lower<T, true>(X, xp, G, gp, l, b);
    } else {
      gram_lower<T, false>(round == 0 ? c : qp, b, G, gp, l, b);
    }
    __syncthreads();
    if (b <= 32) {
      chol_lanes(G, gp, lj, b);
      __syncthreads();
    } else {
      chol_clamped(G, gp, lj, g0, b);
    }
    if constexpr (kResident && sizeof(T) == 16) {
      solve_rows<T, 0>(X, xp, G, gp, l, b);  // unrolled, c128 would spill
    } else if constexpr (kResident) {
      // Unrolled up to 32 columns (64 in f32); past that 8-byte types
      // would spill.
      if (b <= 16) solve_rows<T, 16>(X, xp, G, gp, l, b);
      else if (b <= 32) solve_rows<T, 32>(X, xp, G, gp, l, b);
      else solve_rows<T, sizeof(T) == 4 ? kMaxPanel : 0>(X, xp, G, gp, l, b);
    } else {
      solve_right_lh(round == 0 ? c : qp, qp, G, gp, l, b);
    }
    __syncthreads();  // round 2 reads every row of Q1
  }
  if constexpr (kResident) {
    if (mover)
      for (int64_t r = threadIdx.x / b; r < l; r += rows_a_pass) qp[r * b + p] = X[r * xp + p];
  }
}

template <class T>
size_t factor_smem(bool resident, int64_t l, int b) {
  return sizeof(T) * ((resident ? l * panel_pitch<T>(b) : 0) +
                      static_cast<size_t>(b) * factor_pitch(b) + b) +
         sizeof(real_t<T>) * b;
}

// The launchers return the launch's status: that of a refused shared-memory
// request, or the launch's own (common.cuh, launch).
template <class T>
cudaError_t launch_factor(const void* c, void* qp, int64_t l, int b, cudaStream_t stream) {
  const T* cc = static_cast<const T*>(c);
  T* q = static_cast<T*>(qp);
  if (factor_smem<T>(true, l, b) <= kFactorSmemBudget)
    return launch(panel_factor_kernel<T, true>, dim3(1), dim3(kFactorThreads),
                  factor_smem<T>(true, l, b), stream, cc, q, l, b);
  return launch(panel_factor_kernel<T, false>, dim3(1), dim3(kFactorThreads),
                factor_smem<T>(false, l, b), stream, cc, q, l, b);
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

// panel_step's sweep: W = Q_p^H Z by panel_gram's pass (no Gram), then O
// and colnorms^2(O) by panel_apply's, both on `stream`; w (b x n) is
// required, the W the second launch reads.
extern "C" int repro_panel_gram(int dtype, const void* c, const void* z, void* g, void* v,
                                int64_t l, int64_t b, int64_t n, void* stream);
extern "C" int repro_panel_apply(int dtype, const void* qp, const void* w, const void* z,
                                 void* o, void* r2, int64_t l, int64_t b, int64_t n,
                                 void* stream);

extern "C" int repro_panel_sweep(int dtype, const void* qp, const void* z,
                                 void* o, void* w, void* r2, int64_t l,
                                 int64_t b, int64_t n, void* stream) {
  if (bad_sizes(l, b, n) || w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = repro_panel_gram(dtype, qp, z, nullptr, w, l, b, n, stream);
  if (rc != 0) return rc;
  return repro_panel_apply(dtype, qp, w, z, o, r2, l, b, n, stream);
}

// panel_coeff's sweep: W = Q_p^H Z and r2 = max(r2_in - colnorms^2(W), 0)
// in one launch of panel_gram's pass (no Gram, the downdate in its
// epilogue).
extern "C" int repro_panel_gram_downdate(int dtype, const void* c, const void* z,
                                         const void* r2_in, void* v, void* r2, int64_t l,
                                         int64_t b, int64_t n, void* stream);

extern "C" int repro_panel_coeff_sweep(int dtype, const void* qp, const void* z,
                                       const void* r2_in, void* w, void* r2,
                                       int64_t l, int64_t b, int64_t n,
                                       void* stream) {
  if (bad_sizes(l, b, n)) return static_cast<int>(cudaErrorInvalidValue);
  return repro_panel_gram_downdate(dtype, qp, z, r2_in, w, r2, l, b, n, stream);
}
